"""repro_torch.serve — slot-based continuous-batching inference engine."""
from .engine import Engine, EngineStats, Request, ServeConfig  # noqa: F401
