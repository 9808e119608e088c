"""Parameter / activation / cache sharding rules — port of
``repro/launch/sharding.py``.

Three policies, as in JAX:

* ``tp`` — tensor parallelism over the "model" axis only; parameters
  replicated across data (small models).
* ``fsdp_tp`` — 2-D sharding: "model" shards the TP dimension and
  ("pod", "data") shard a second dimension FSDP-style (big models).
* ``fsdp`` — pure FSDP: every parameter sharded over all axes on its
  largest divisible dim, the batch over every axis.

The rules are name-based over the JAX tree's key paths
(:func:`repro_torch.convert.param_tree`) and return the port's own spec,
JAX's ``PartitionSpec`` as a tuple: per tensor dim an axis name, a tuple
of names or None.  Any dim not divisible by its axes falls back to None.
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on every mesh dim named for tensor dim d,
``Replicate()`` elsewhere; names in a tuple shard in mesh order, as JAX's
major-to-minor order does.  The rules read only the mesh's axis names and
sizes (``mesh_dim_names`` and ``shape``), so they also run on a stand-in
with those two attributes.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.convert import tree_map

__all__ = [
    "param_sharding_rules",
    "tree_shardings",
    "to_placements",
    "batch_sharding",
    "frontend_sharding",
    "cache_shardings",
    "act_spec",
    "make_shard_act",
    "pick_policy",
]


def pick_policy(total_params: int) -> str:
    """fsdp_tp at 3 B parameters and above (16 B/param of optimizer
    state), else tp."""
    return "fsdp_tp" if total_params >= 3e9 else "tp"


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _axsize(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = dict(zip(_names(mesh), mesh.shape))
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _shard_if_divisible(mesh, shape, *axes) -> tuple:
    """The spec, with None on every dim its axes do not divide."""
    return tuple(ax if ax is not None and dim % _axsize(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, axes))


def _rule(path: str, shape, mesh, policy: str, fsdp) -> tuple:
    """The spec of one parameter.  ``fsdp`` = the ('pod', 'data') axes
    that shard the second dim under fsdp_tp (None under tp)."""
    nd = len(shape)
    if policy == "fsdp":
        allax = tuple(a for a in ("pod", "data", "model") if a in _names(mesh))
        # the largest divisible dim over the combined axes
        for i in sorted(range(nd), key=lambda i: -shape[i]):
            if shape[i] % _axsize(mesh, allax) == 0 and shape[i] > 1:
                spec = [None] * nd
                spec[i] = allax
                return tuple(spec)
        return (None,) * nd
    d2 = fsdp if policy == "fsdp_tp" else None

    def spec(*axes):
        # None for the leading stacked dims the rule does not name
        axes = (None,) * (nd - len(axes)) + tuple(axes)
        return _shard_if_divisible(mesh, shape, *axes)

    leaf = path.split("/")[-1]
    if leaf in ("embed", "lm_head"):                 # [V, d]
        return spec("model", d2)
    if leaf in ("wq", "wk", "wv", "w_r", "w_k", "w_v", "w_g"):
        return spec(d2, "model")                     # [d, H*hd]
    if leaf in ("wo", "w_o"):
        return spec("model", d2)                     # [H*hd, d]
    is_moe = "/moe/" in path
    if leaf in ("w_gate", "w_up"):                   # moe: [(rep,) E, d, f]
        if is_moe and shape[-3] % _axsize(mesh, "model") == 0:
            return spec("model", d2, None)           # whole experts per rank
        return spec(d2, "model")
    if leaf == "w_down":                             # moe: [(rep,) E, f, d]
        if is_moe and shape[-3] % _axsize(mesh, "model") == 0:
            return spec("model", None, d2)
        return spec("model", d2)
    if leaf == "router":                             # [d, E]
        return spec(d2, None)
    if leaf == "in_proj":                            # [d, 2*d_in]
        return spec(d2, "model")
    if leaf in ("x_proj", "out_proj"):               # [d_in, *]
        return spec("model", d2)
    if leaf == "dt_proj":                            # [r, d_in]
        return spec(d2, "model")
    if leaf == "conv_w":                             # [K, d_in]
        return spec(None, "model")
    if leaf == "a_log":                              # [d_in, N]
        return spec("model", None)
    if leaf in ("dt_bias", "d_skip", "decay_base", "ln_x"):
        return spec("model")                         # [d_in] / [dh]
    if leaf == "decay_a":                            # [d, LORA]
        return spec(d2, None)
    if leaf == "decay_b":                            # [LORA, dh]
        return spec(None, "model")
    if leaf == "bonus_u":                            # [H, hd]
        return spec(None, None)
    if leaf == "frontend_proj":                      # [F, d]
        return spec(None, "model")
    if leaf in ("bq", "bk", "bv"):
        return spec("model")
    # norms, scalars, mixes
    return (None,) * nd


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree))
    return prefix


def param_sharding_rules(shapes_tree, mesh, policy: str = "tp"):
    """The spec of every leaf of ``shapes_tree`` (anything with a
    ``shape``: tensors, meta tensors), in the tree's structure."""
    fsdp = tuple(a for a in ("pod", "data") if a in _names(mesh)) or None
    return tree_map(lambda leaf, path: _rule(path, tuple(leaf.shape), mesh, policy, fsdp),
                    shapes_tree, _paths(shapes_tree))


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that spec entry d names, ``Replicate()`` on the rest.  A tuple of
    names must list them in mesh order (JAX's major-to-minor order)."""
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(shapes_tree, mesh, policy: str = "tp"):
    """The placements of every leaf of ``shapes_tree`` on ``mesh``."""
    specs = param_sharding_rules(shapes_tree, mesh, policy)
    return tree_map(lambda leaf, spec: to_placements(spec, mesh), shapes_tree, specs)


def batch_sharding(mesh, batch: int | None = None, policy: str = "fsdp_tp") -> tuple:
    """tokens/labels [B, S]: the batch over the batch axes (replicated when
    the batch does not divide them, e.g. long_500k's batch of 1).  Pure
    FSDP shards the batch over every axis."""
    names = _names(mesh)
    candidates = [tuple(a for a in ("pod", "data") if a in names)]
    if policy == "fsdp":
        candidates.insert(0, tuple(a for a in ("pod", "data", "model") if a in names))
        candidates.insert(1, tuple(a for a in ("data", "model") if a in names))
    for axes in candidates:
        if axes and (batch is None or batch % _axsize(mesh, axes) == 0):
            return (axes, None)
    return (None, None)


def frontend_sharding(mesh, batch: int | None = None) -> tuple:
    """Frontend embeddings / memory [B, M, d]: the batch over the data axes."""
    dp = tuple(a for a in ("pod", "data") if a in _names(mesh))
    if batch is not None and (not dp or batch % _axsize(mesh, dp) != 0):
        return (None, None, None)
    return (dp, None, None)


def cache_shardings(cache_tree, mesh, batch: int):
    """Decode caches: the batch over the data axes when divisible; an
    attention cache's long sequence, or a Mamba state's d_in, over
    "model"."""
    dp = tuple(a for a in ("pod", "data") if a in _names(mesh))
    batch_ok = batch % (_axsize(mesh, dp) if dp else 1) == 0
    msize = _axsize(mesh, "model")

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        axes = [None] * nd
        # attn k/v [rep, B, S, hkv, hd]; mamba conv [rep, B, K, d_in];
        # mamba ssm [rep, B, d_in, N]; rwkv last_x [rep, B, d];
        # rwkv state [rep, B, H, hd, hd]
        if batch_ok and nd >= 2:
            axes[1] = dp
        if nd == 5 and shape[2] > 1024:
            if shape[2] % msize == 0:
                axes[2] = "model"
        elif nd == 4 and shape[2] % msize == 0:
            axes[2] = "model"
        return _shard_if_divisible(mesh, shape, *axes)

    return tree_map(spec, cache_tree)


def act_spec(mesh, policy: str, shape: tuple, kind: str = "residual"):
    """The spec that JAX's activation hook pins a tensor of ``shape`` and
    ``kind`` to, or None where it leaves the tensor alone."""
    names = _names(mesh)
    nd = len(shape)
    if policy == "fsdp":
        if nd < 2:
            return None
        allax = tuple(a for a in ("pod", "data", "model") if a in names)
        b = allax if shape[0] % _axsize(mesh, allax) == 0 else None
        return (b,) + (None,) * (nd - 1)
    dp = tuple(a for a in ("pod", "data") if a in names)
    msize = _axsize(mesh, "model") if "model" in names else 1
    bshard = dp if (dp and shape[0] % _axsize(mesh, dp) == 0) else None
    if kind == "mamba_din" and nd == 3:              # [B, S, d_in]
        return (bshard, None, "model" if shape[-1] % msize == 0 else None)
    if kind == "moe_tokens" and nd == 4:             # [G, E, C, d]
        return (bshard, "model" if shape[1] % msize == 0 else None, None, None)
    if kind == "moe_hidden" and nd == 4:             # [G, E, C, f]
        if shape[1] % msize == 0:                    # expert parallelism
            return (bshard, "model", None, None)
        return (bshard, None, None, "model" if shape[-1] % msize == 0 else None)
    if nd != 3:
        return None
    if kind == "attn_in":
        # the sequence gathered once at attention entry; heads then split
        return (bshard, None, None)
    if kind == "logits":
        return (bshard, None, "model" if shape[-1] % msize == 0 else None)
    # residuals between layers: the sequence over "model" (Megatron SP)
    sshard = "model" if shape[1] > 1 and shape[1] % msize == 0 else None
    return (bshard, sshard, None)


def make_shard_act(mesh, policy: str = "fsdp_tp"):
    """The activation hook injected into the model: ``fn(x, kind)``
    redistributes a DTensor to the placements of :func:`act_spec` and
    returns a plain tensor, or a kind the hook leaves alone, unchanged."""
    from torch.distributed.tensor import DTensor

    def shard_act(x, kind="residual"):
        if not isinstance(x, DTensor):
            return x
        spec = act_spec(mesh, policy, tuple(x.shape), kind)
        if spec is None:
            return x
        return x.redistribute(mesh, to_placements(spec, mesh))

    return shard_act
