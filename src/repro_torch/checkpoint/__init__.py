"""repro_torch.checkpoint — CDC-deduplicated fault-tolerant checkpointing."""
from .store import CheckpointManager  # noqa: F401
