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

Two paths, chosen once a call from the leaves' devices.  Where every
leaf is on the card (plain tensors, or DTensors by their local shards),
two hand-written passes of :mod:`repro_torch.kernels.adamw` run: a sum
of squares for the norm (each leaf's sum reduced over the mesh dims its
grad is sharded on) and a fused update per leaf, with no whole-leaf
temporary.  They give the eager path's m, v, master and params bit for
bit for the same clip scale; only the norm's summation order differs.
A card leaf the kernels cannot take raises; a strided one is updated
through a contiguous copy.  CPU and meta leaves take the eager ATen code
(:func:`adamw_update_eager`), which is also the oracle the card tests
hold the kernels to.  While a torch profiler records, the counters
``optim.fused_params`` and ``optim.eager_params`` add the parameter
elements each path updated.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.kernels import adamw as fused
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.tracer import profiler_recording

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_eager",
           "global_norm", "clip_by_global_norm"]

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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm) as an f32 0-d tensor where the norm is."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))      # the scale in the gradient's dtype, as JAX
    return grads, norm


def _bias_and_lr(cfg: AdamWConfig, step: torch.Tensor, lr_scale):
    """The f32 bias corrections and learning rate of step ``step`` (already
    incremented), as 0-d tensors where the step is."""
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)
    lr = (cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=t.device))
    return bc1, bc2, lr


def _update_eager(cfg: AdamWConfig, leaves, bc1, bc2, lr) -> None:
    """The update of (param, clipped grad, m, v, master) leaves in ATen ops."""
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


def _local(t):
    """A DTensor's shard on this rank; anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(params, grads, state) -> list:
    return list(zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), tree_leaves(state["master"])))


def _sharded_dims(leaf, mesh) -> tuple:
    """The mesh dims (of more than one rank) over which a leaf's local sum
    of squares is a part: those its tensors are sharded on.  The param,
    grad and state of a DTensor leaf share the mesh and the placements."""
    p = leaf[0]
    if mesh is None and not any(isinstance(t, DTensor) for t in leaf):
        return ()
    if not all(isinstance(t, DTensor) and t.device_mesh == mesh
               and tuple(t.placements) == tuple(p.placements) for t in leaf) \
            or any(pl.is_partial() for pl in p.placements):
        raise ValueError("AdamW on the card takes DTensor leaves whose param, grad, m, v and "
                         "master share one mesh and one placement, none of them partial")
    return tuple(d for d, pl in enumerate(p.placements) if pl.is_shard() and mesh.size(d) > 1)


def _mesh_sumsq(sums: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """The global sum of squares, from the local per-leaf sums (and their
    total last) and each leaf's :func:`_sharded_dims`: the leaves of one
    set of dims summed, then all-reduced over those dims."""
    if not any(dims):
        return sums[-1]
    total = None
    for key in dict.fromkeys(dims):
        part = sums[[i for i, d in enumerate(dims) if d == key]].sum()
        for d in key:
            dist.all_reduce(part, group=mesh.get_group(d))
        total = part if total is None else total + part
    return total


def _update_fused(cfg: AdamWConfig, leaves, state, lr_scale) -> torch.Tensor:
    """The two kernels' step over leaves on the card, DTensors by their
    local shards; returns the norm (replicated over a DTensor mesh)."""
    p0 = leaves[0][0]
    mesh = p0.device_mesh if isinstance(p0, DTensor) else None
    dims, work, strided = [], [], []
    for leaf in leaves:
        dims.append(_sharded_dims(leaf, mesh))
        local = [_local(t) for t in leaf]
        dense = [t if t.is_contiguous() else t.contiguous() for t in local]
        if not fused.takes(*dense):
            raise ValueError(
                "AdamW on the card takes a param and grad of one type (f32, bf16 or f16), "
                f"f32 or bf16 moments and an f32 master of one shape, not "
                f"{[(tuple(t.shape), t.dtype, t.device.type) for t in dense]}")
        strided += [(t, d) for t, d in zip(local, dense) if d is not t]
        work.append(dense)
    gnorm = torch.sqrt(_mesh_sumsq(fused.grad_sumsq(g for _, g, *_ in work), dims, mesh))
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["step"] += 1
    bc1, bc2, lr = _bias_and_lr(cfg, _local(state["step"]), _local(lr_scale))
    for leaf in work:            # each leaf's clip multiply and update, one launch
        fused.update(*leaf, scale, bc1, bc2, lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
    for t, dense in strided:
        t.copy_(dense)
    if mesh is not None:
        gnorm = DTensor.from_local(gnorm, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return gnorm


@torch.no_grad()
def adamw_update_eager(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """:func:`adamw_update` in ATen ops, on leaves of any device: the path
    of CPU and meta leaves, and the plain version of the card's kernels."""
    leaves = _leaves(params, grads, state)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"] += 1
    _update_eager(cfg, leaves, *_bias_and_lr(cfg, state["step"], lr_scale))
    return params, state, {"grad_norm": gnorm}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """One AdamW step in place: clips ``grads``, updates ``state`` and
    writes the new params into ``params``.  Returns (params, state,
    metrics) with the ``grad_norm`` metric, as the JAX function does."""
    leaves = _leaves(params, grads, state)
    on_card = bool(leaves) and all(_local(t).device.type == "cuda"
                                   for leaf in leaves for t in leaf)
    if on_card:
        metrics = {"grad_norm": _update_fused(cfg, leaves, state, lr_scale)}
    else:
        _, _, metrics = adamw_update_eager(cfg, params, grads, state, lr_scale)
    if profiler_recording():
        METRICS.counter("optim.fused_params" if on_card else "optim.eager_params",
                        sum(p.numel() for p, *_ in leaves))
    return params, state, metrics
