"""The training loop — port of ``repro/runtime/train_loop.py``: data
prefetch, train steps, periodic async checkpoints, fault injection hooks,
straggler monitoring.

Runs on the card by default and on the CPU when asked
(``device="cpu"``).  Where JAX jits a pure ``train_step`` and donates its
buffers, :meth:`Trainer.step_fn` runs eagerly and updates the model's
parameters and the optimizer state in place.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import param_tree, tree_leaves, tree_map
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.models import LM
from repro_torch.obs.tracer import device_span
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

from .fault import FailureInjector, StepTimer, StragglerMonitor

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10      # JAX's field; its loop does not read it either
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    async_ckpt: bool = True
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """Single-host trainer on one device.

    The model's parameters are drawn from ``tcfg.seed`` (f32 unless
    ``param_dtype`` says otherwise) and require grad; ``remat`` is
    "none", as in the JAX trainer (set ``trainer.model.remat`` to
    "full" or "dots" to recompute layers instead).  ``mesh`` is accepted
    and unused, as in the JAX trainer: a sharded step is
    :func:`repro_torch.launch.steps.build_train_step`'s.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, *, mesh=None, param_dtype=None, attn_chunk: int = 64,
                 injector: FailureInjector | None = None, device="cuda") -> None:
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.injector = injector
        self.monitor = StragglerMonitor()
        self.model = LM(cfg, param_dtype=param_dtype or torch.float32,
                        attn_chunk=attn_chunk, max_seq=shape.seq_len + 8,
                        remat="none", seed=tcfg.seed, device=device)
        self.device = self.model.device
        self._drawn = True              # parameters as drawn from the seed
        self.data = SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            seed=tcfg.seed,
            frontend_tokens=cfg.frontend_tokens,
            frontend_dim=cfg.frontend_dim,
        ))
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep,
                                 async_save=tcfg.async_ckpt)

    def params(self) -> dict:
        """The model's parameters as the JAX-layout tree, grad on."""
        tree = param_tree(self.model)
        for p in tree_leaves(tree):
            p.requires_grad_(True)
        return tree

    def step_fn(self, params, opt_state, batch, mark=None):
        """One train step (the JAX trainer's ``train_step``): the loss and
        its gradients by autograd, then AdamW with the warmup-cosine
        scale, in place.  ``params`` is :meth:`params`' tree, the model's
        own parameters; ``batch`` holds ``tokens`` and ``labels`` on the
        model's device.  ``mark(name)``, if given, is called as the
        forward, backward and AdamW phases start ("forward", "backward",
        "adamw") and at the end ("end"), for timing; while a torch profiler
        records, the three phases run under the device spans
        ``repro_torch.train.forward`` / ``.backward`` / ``.adamw``.
        Returns (params, opt_state, metrics) with the ``loss`` and
        ``grad_norm`` metrics.
        """
        mark = mark or (lambda name: None)
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None                # no stale grads live during the forward
        mark("forward")
        with device_span("repro_torch.train.forward"):
            loss = self.model.loss(batch)
        mark("backward")
        with device_span("repro_torch.train.backward"):
            loss.backward()
        mark("adamw")
        with device_span("repro_torch.train.adamw"):
            grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                             params)
            lr_scale = warmup_cosine(opt_state["step"], warmup=10,
                                     total=max(self.tcfg.steps, 20))
            params, opt_state, metrics = adamw_update(self.tcfg.opt, params, grads,
                                                      opt_state, lr_scale)
            for p in leaves:
                p.grad = None
        mark("end")
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    # ------------------------------------------------------------------ #
    def init_or_restore(self):
        """(params, opt_state, first step): fresh from the seed, then the
        latest checkpoint's values copied in, if there is one."""
        if not self._drawn:
            self.model.init_params(self.tcfg.seed)
        self._drawn = False
        params = self.params()
        # without tcfg.opt.moment_dtype, as the JAX trainer calls it: the
        # moments stay f32 whatever the config says
        opt_state = adamw_init(params)
        start = 0
        if self.ckpt.latest_step() is not None:
            state, meta = self.ckpt.restore({"params": params, "opt": opt_state})
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src),
                         {"params": params, "opt": opt_state}, state)
            start = int(meta["step"]) + 1
        return params, opt_state, start

    def batch(self, host_batch: dict) -> dict:
        """A numpy batch as integer tensors on the model's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in host_batch.items()}

    def run(self, steps: int | None = None) -> dict:
        """Train; returns metrics history. Resumes from checkpoints."""
        steps = steps or self.tcfg.steps
        params, opt_state, start = self.init_or_restore()
        it = (self.data.batch_at(s) for s in range(start, steps))
        prefetch = Prefetcher(it)
        history = {"loss": [], "step": [], "restarted_at": start}
        timer = StepTimer()
        try:
            for step in range(start, steps):
                if self.injector is not None:
                    self.injector.check(step)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, self.batch(prefetch.get()))
                loss = float(metrics["loss"])    # waits for the step's work
                self.monitor.record(0, timer.lap())
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss diverged at {step}")
                history["loss"].append(loss)
                history["step"].append(step)
                if (step + 1) % self.tcfg.ckpt_every == 0 or step == steps - 1:
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
        finally:
            prefetch.close()
            # also on a fault: a restart then finds every checkpoint written
            self.ckpt.wait()
        return history
