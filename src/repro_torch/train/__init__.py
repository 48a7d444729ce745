"""repro_torch.train — optimizer, train step, fault-tolerant loop."""
from .optim import OptConfig, OptState, init as opt_init, update as opt_update  # noqa: F401
from .step import grads_and_metrics, make_eval_step, make_train_step  # noqa: F401
from .loop import LoopConfig, StragglerMonitor, Trainer  # noqa: F401
