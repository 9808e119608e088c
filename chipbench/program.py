"""The system under test, as the benchmark builds it: the port's ``LM``
and ``Trainer`` for a configuration file, holding the benchmark's
weights.

The model is built on the meta device (no draw), its storage allocated
on the card, and every parameter drawn there by
:func:`chipbench.weights.fill_model`; its rotary table is the program's
own, built by its own function.  This is the only module of the
benchmark, with the drivers that call into what it returns, that imports
the program.
"""
from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import torch

from chipbench import weights

__all__ = ["model_config", "build_lm", "build_trainer", "flash_launches"]

_ROOT = Path(__file__).resolve().parents[1]


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: its arch's
    config with every size of ``model`` put in."""
    from repro_torch.configs import get_config
    return replace(get_config(config["arch"]), **config["model"])


def _materialize(lm, seed: int, device) -> None:
    from repro_torch.models.layers import rope_frequencies
    lm.to_empty(device=device)
    weights.fill_model(lm.named_parameters(), seed)
    lm.cos_sin = rope_frequencies(lm.cfg.hd, lm.max_seq, lm.cfg.rope_theta, device)


def build_lm(config: dict, seed: int, max_seq: int, device):
    """The serving model, its weights those of ``seed``."""
    from repro_torch.models import LM
    lm = LM(model_config(config), param_dtype=weights.DTYPES[config["param_dtype"]],
            capacity_factor=config["capacity_factor"], max_seq=max_seq, device="meta")
    _materialize(lm, seed, device)
    return lm


def build_trainer(config: dict, seed: int, batch: int, seq_len: int,
                  schedule_steps: int, device):
    """The trainer (params in the configuration's type, float32 AdamW
    state), its weights those of ``seed``; nothing is checkpointed unless
    ``Trainer.run`` is called, which the benchmark never does."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    tcfg = TrainerConfig(steps=schedule_steps, seed=seed,
                         ckpt_dir=str(_ROOT / "build" / "chipbench" / "ckpt"))
    trainer = Trainer(model_config(config), ShapeConfig("chipbench", seq_len, batch, "train"),
                      tcfg, param_dtype=weights.DTYPES[config["param_dtype"]], device="meta")
    trainer.model.capacity_factor = config["capacity_factor"]
    _materialize(trainer.model, seed, device)
    trainer.device = torch.device(device)
    return trainer


def flash_launches() -> dict:
    """The flash kernels' launches so far, by kernel and mask."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    return dict(flash_attention_bhsd.mask_launches)
