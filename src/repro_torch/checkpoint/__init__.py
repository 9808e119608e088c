"""Checkpointing of the port — ``repro/checkpoint`` in torch."""
from .checkpointer import Checkpointer, checkpoint_meta, load_pytree, save_pytree

__all__ = ["Checkpointer", "checkpoint_meta", "load_pytree", "save_pytree"]
