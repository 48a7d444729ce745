"""repro_torch.roofline — three-term roofline terms of a step on H100
constants, from one rank's op-by-op cost count."""
from . import constants  # noqa: F401
from .analyze import (  # noqa: F401
    CollectiveStats,
    Roofline,
    from_counts,
    model_flops_for,
    ring_bytes,
)
from .cost import CostCounter  # noqa: F401
