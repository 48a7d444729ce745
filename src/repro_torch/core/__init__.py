"""repro_torch.core — SeqCDC (the paper's contribution) and the CDC
algorithm zoo: parameters, the numpy oracle, phase-1 masks, the W-block
automaton, the chunker registry and the baselines.

Exports resolve lazily (``repro_torch._lazy``): ``import repro_torch`` and
the torch-free modules (``params``, ``oracle``) import no torch, so the
spawned shard servers stay numpy+stdlib.  Touching a registry name
imports ``chunker``, which registers every baseline, as the reference's
eager ``core/__init__`` does.
"""
from repro_torch._lazy import install as _install

#: public name -> defining submodule (resolved on first attribute access)
_EXPORTS = {
    "DECREASING": ".params",
    "INCREASING": ".params",
    "SeqCDCParams": ".params",
    "derived_params": ".params",
    "paper_params": ".params",
    "Chunker": ".chunker",
    "available": ".chunker",
    "make_chunker": ".chunker",
    "register": ".chunker",
    "boundaries_batch": ".seqcdc",
    "boundaries_sequential": ".seqcdc",
    "boundaries_two_phase": ".seqcdc",
}

_SUBMODULES = ("automaton", "baselines", "calibrate", "chunker", "masks",
               "oracle", "params", "seqcdc")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)

__getattr__, __dir__ = _install(__name__, _EXPORTS, _SUBMODULES)
