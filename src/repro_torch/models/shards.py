"""Local regions of a model run on DTensors.

Under a mesh (:mod:`repro_torch.launch.steps`) the model's parameters and
activations are DTensors, and most of its work (norms, projections,
residual adds, the loss) runs through DTensor's own sharding rules.  What
those rules cannot carry runs in a *local region*: the kernels, which
read ``data_ptr()`` and strides, and code that builds plain tensors of
its own (RoPE tables, scan states, routing indices).  A region
redistributes each DTensor input to the placements it names, calls the
function on the local shards and wraps the results as DTensors again.

The one rule that keeps the gradients right: along a mesh dim where some
input is sharded, each rank computes a different part of the function,
so the gradient of an input that is replicated there is that rank's
partial sum (``Partial``); along a mesh dim where no input is sharded,
every rank computes the same thing and the gradient stays replicated.
A mesh dim of size 1 moves nothing.

Outside a mesh nothing here runs: the model calls the function on its
plain tensors directly.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["is_dtensor", "on_shards", "batch_placements", "split_on_model"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def batch_placements(x: DTensor) -> list:
    """``x``'s ``Shard(0)`` entries kept, every other mesh dim replicated:
    the placements of a region that keeps the batch where it is."""
    return [p if p == Shard(0) else Replicate() for p in x.placements]


def split_on_model(placements: Sequence, x: DTensor, dim: int, *counts: int) -> list:
    """``placements`` with ``Shard(dim)`` on the ``"model"`` mesh dim where it
    is replicated and every count in ``counts`` divides that dim's size (the
    heads, or the channels, split over the tensor-parallel axis)."""
    mesh = x.device_mesh
    out = list(placements)
    for i, name in enumerate(mesh.mesh_dim_names or ()):
        size = mesh.size(i)
        if (name == "model" and out[i] == Replicate()
                and all(c % size == 0 for c in counts)):
            out[i] = Shard(dim)
    return out


def on_shards(fn: Callable, inputs: Sequence, out_placements):
    """``fn`` on the local shards of ``inputs``, its results as DTensors.

    ``inputs``: ``(DTensor, placements)`` pairs; each is redistributed to
    its placements and passed as its local tensor.  ``out_placements``:
    one placements list, or a tuple of them when ``fn`` returns a tuple.
    Every sharded dim must divide evenly.
    """
    mesh = inputs[0][0].device_mesh
    # a mesh dim of size 1 splits nothing: every input keeps its own
    # placement there, so no collective runs on it (a mesh of one runs none)
    ones = {i for i in range(mesh.ndim) if mesh.size(i) == 1}
    inputs = [(x, [x.placements[i] if i in ones else p for i, p in enumerate(pl)])
              for x, pl in inputs]
    split = {i for _, pl in inputs for i, p in enumerate(pl)
             if isinstance(p, Shard) and i not in ones}
    local = []
    for x, pl in inputs:
        x = x.redistribute(mesh, pl)
        grads = [Partial() if i in split and isinstance(p, Replicate) else p
                 for i, p in enumerate(pl)]
        local.append(x.to_local(grad_placements=grads))
    out = fn(*local)

    def wrap(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        pl = [Replicate() if i in ones and isinstance(p, Partial) else p
              for i, p in enumerate(pl)]
        return DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, pl) for t, pl in zip(out, out_placements))
    return wrap(out, out_placements)

