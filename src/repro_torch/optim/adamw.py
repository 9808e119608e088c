"""AdamW with f32 master weights over (possibly bf16) params — port of
``repro/optim/adamw.py``.

The state is a tree that mirrors the param tree (:mod:`repro_torch.convert`
trees: nested dicts and lists of tensors): ``step`` (int32), ``m``, ``v``
and ``master``.  The arithmetic is the JAX function's, in its order: the
clip scale is cast to each gradient's dtype before the multiply, the step
is incremented before the f32 bias corrections, moments update in f32 and
are stored in their own dtype, and new params are ``master`` cast to the
param's dtype.

Unlike the JAX function, which returns new trees (and donates the old
buffers under ``jit``), :func:`adamw_update` updates params, grads and
state in place under ``torch.no_grad()``: eager PyTorch has no buffer
donation, and at full width two copies of the 16 bytes a parameter of
params and state do not fit on one card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.convert import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 Adam moments save 8 bytes/param; update math stays f32
    moment_dtype: str = "float32"


def adamw_init(params, moment_dtype: str = "float32") -> dict:
    """Zero moments in ``moment_dtype`` and an f32 master copy of params
    (an explicit copy: an f32 param is not aliased).  DTensor params give
    moments and master of their placements and a replicated ``step``."""
    mdt = _DTYPES[moment_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=mdt, requires_grad=False)  # noqa: E731
    leaf = next(iter(tree_leaves(params)))
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return {
        "step": step,
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, leaves summed in JAX's
    leaf order (sorted dict keys).  Over DTensor leaves the sums are
    partial on each rank and the norm is reduced over every shard."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))      # the scale in the gradient's dtype, as JAX
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """One AdamW step in place: clips ``grads``, updates ``state`` and
    writes the new params into ``params``.  Returns (params, state,
    metrics) with the ``grad_norm`` metric, as the JAX function does."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"] += 1
    t = state["step"].to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)
    lr = (cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=t.device))
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                 tree_leaves(state["v"]), tree_leaves(state["master"]))
    for p, g, m, v, master in leaves:
        g = g.float()
        m32 = cfg.b1 * m.float() + (1.0 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1.0 - cfg.b2) * g * g
        m.copy_(m32)
        v.copy_(v32)
        # (m / bc1) / (sqrt(v / bc2) + eps), one temporary at a time
        update = v32.div_(bc2).sqrt_().add_(cfg.eps)
        update = m32.div_(bc1).div_(update)
        update.add_(cfg.weight_decay * master).mul_(lr)
        master.sub_(update)
        p.copy_(master)
        del g, m32, v32, update
    return params, state, {"grad_norm": gnorm}
