"""Pipeline-parallel execution: the GPipe microbatch schedule over a
"stage" mesh axis — port of ``repro/runtime/pipeline.py``.

The scheduler decides *which* blocks form stages; this module is the
runtime that executes a stage-partitioned model.  Each rank of the
``axis`` group is one stage:

* stage parameters are stacked ``[n_stages, ...]`` and sharded
  ``Shard(0)`` over ``axis`` (JAX's ``P(axis)``): each rank takes its own
  row;
* microbatches flow through a rotating buffer: at step t, stage 0 injects
  microbatch t (while t < µ), *every* stage runs ``stage_fn`` on its
  buffer (during fill and drain on whatever the buffer holds, as JAX's
  ``shard_map`` body does), the last stage keeps microbatch ``t − s``
  when that index is valid, and the buffer moves one stage forward around
  the ring (``dist.batch_isend_irecv``, JAX's ``ppermute``);
* total steps = µ + S − 1 (fill + drain); every rank gets the last
  stage's outputs (a broadcast, JAX's ``result[-1]``);
* autograd through the runner gives the GPipe backward: the permute's
  gradient moves from stage s+1 back to s, and the broadcast's gives the
  gradient to the last stage alone.  Every rank's permutes form one chain
  that the result depends on, so each rank runs their backward exchanges
  in the forward's reverse order, paired with its neighbours'.

With one stage the permute and the broadcast move nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.convert import tree_map

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(per_stage: list) -> dict:
    """Stack a list of per-stage param trees along a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage)


def _exchange(t: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send ``t`` to group rank ``send_to`` and receive one like it from
    ``recv_from``, in one batch of point-to-point ops."""
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, send_to),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    """The buffer from stage s to stage s+1 around the ring; its gradient
    from s+1 back to s."""

    @staticmethod
    def forward(ctx, y, group, stage, n_stages):
        ctx.group, ctx.stage, ctx.n = group, stage, n_stages
        if n_stages == 1:
            return y.clone()
        return _exchange(y, group, (stage + 1) % n_stages, (stage - 1) % n_stages)

    @staticmethod
    def backward(ctx, grad):
        if ctx.n == 1:
            return grad, None, None, None
        return (_exchange(grad, ctx.group, (ctx.stage - 1) % ctx.n, (ctx.stage + 1) % ctx.n),
                None, None, None)


class _Inject(torch.autograd.Function):
    """Stage 0's new microbatch in place of the buffer it received: the
    buffer's gradient is zero, but the edge keeps stage 0's permutes in one
    chain, so every rank runs their backward exchanges in the same order."""

    @staticmethod
    def forward(ctx, received, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad), grad


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank; their gradient to the last
    stage alone (every rank holds the same result, so one copy's gradient
    is the whole gradient).  ``last_buf``, the ring's final buffer, gets a
    zero gradient, so the backward reaches every rank's permutes."""

    @staticmethod
    def forward(ctx, t, last_buf, group, stage, n_stages):
        ctx.last = stage == n_stages - 1
        if n_stages == 1:
            return t.clone()
        out = t.clone().contiguous()
        dist.broadcast(out, dist.get_global_rank(group, n_stages - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return ((grad if ctx.last else torch.zeros_like(grad)), torch.zeros_like(grad[0]),
                None, None, None)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str = "stage",
                   microbatches: int | None = None):
    """Run ``x`` through a pipeline of stages.

    Args:
      stage_fn: ``(params_slice, x_mb) -> x_mb`` — one stage's compute.
      stage_params: tree of DTensors stacked ``[S, ...]``, sharded
        ``Shard(0)`` over ``axis`` (each rank's local shard is its row).
      x: ``[B, ...]`` global input batch (the same on every rank).
      mesh: ``DeviceMesh`` with the ``axis`` of size S; this rank's stage is
        its coordinate on it.
      microbatches: µ (defaults to S — the minimum for full utilization).

    Returns ``[B, ...]`` outputs (the same on every rank).
    """
    sub = mesh[axis]
    n_stages = sub.size()
    stage = sub.get_local_rank()
    group = sub.get_group()
    mu = microbatches or n_stages
    b = x.shape[0]
    if b % mu:
        raise ValueError(f"batch {b} not divisible by {mu} microbatches")
    xs = x.reshape((mu, b // mu) + tuple(x.shape[1:]))
    params = tree_map(lambda t: t.to_local()[0], stage_params)

    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0])] * mu
    for t in range(mu + n_stages - 1):
        if stage == 0:
            # stage 0 injects microbatch t (while t < µ)
            buf = _Inject.apply(buf, xs[t if t < mu else 0])
        y = stage_fn(params, buf)
        # microbatch index this stage just produced
        m = t - stage
        if stage == n_stages - 1 and 0 <= m < mu:
            outs = outs[:m] + [y] + outs[m + 1:]
        # rotate stage s -> s+1
        buf = _Permute.apply(y, group, stage, n_stages)
    out = _FromLast.apply(torch.stack(outs), buf, group, stage, n_stages)
    return out.reshape((b,) + tuple(x.shape[1:]))
