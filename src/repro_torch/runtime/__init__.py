from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.runtime.failures import FailureInjector, StragglerMonitor

__all__ = ["Trainer", "TrainerConfig", "FailureInjector", "StragglerMonitor"]
