"""CDC baseline algorithms (paper SSVI "Alternatives").

Importing ``core.chunker`` registers every baseline with its registry:
fixed (XC), gear[_seq], crc[_seq], rabin[_seq], fastcdc[_seq], tttd,
ae[_seq], ram[_seq], beside the seqcdc forms ``core.chunker`` registers
itself.  The submodules resolve lazily (``repro_torch._lazy``).
"""
from repro_torch._lazy import install as _install

_SUBMODULES = ("hash_based", "hashless", "linear_hash", "selectors")

__all__ = list(_SUBMODULES)

__getattr__, __dir__ = _install(__name__, {}, _SUBMODULES)
