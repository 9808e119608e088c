"""Optimizer of the port — ``repro/optim`` in torch."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_eager,
                    clip_by_global_norm, global_norm)
from .schedules import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_eager",
           "clip_by_global_norm", "global_norm", "constant", "warmup_cosine"]
