"""The benchmark's plain float32 reference: the decoders, their loss and
AdamW, in plain PyTorch, importing nothing of the program."""
from .adamw import AdamW, lr_scale
from .model import Reference, exact_float32, lowp_round

__all__ = ["AdamW", "Reference", "exact_float32", "lowp_round", "lr_scale"]
