from .optimizers import AdamW, Adafactor, get_optimizer, clip_by_global_norm, \
    global_norm, cosine_schedule
from .accumulation import accumulated_value_and_grad
from . import compression, schedules

__all__ = ["AdamW", "Adafactor", "get_optimizer", "clip_by_global_norm",
           "global_norm", "cosine_schedule", "accumulated_value_and_grad",
           "compression", "schedules"]
