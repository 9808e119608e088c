"""Step builders — port of ``repro/launch/steps.py``: the train, prefill
and serve (decode) steps of one (arch × shape × mesh) cell, with their
input specs and placements.

Where JAX jits a pure step with in/out shardings, a port step runs
eagerly on DTensors: the model's parameters, the optimizer state, the
batch and the caches carry the placements of
:mod:`repro_torch.launch.sharding` on a ``DeviceMesh``, and the model
calls the activation hook :func:`~repro_torch.launch.sharding.make_shard_act`
at JAX's sites.  The input specs are meta DTensors: shape, dtype and
placements, nothing allocated.  A builder builds its model on the meta
device (the port's ``jax.eval_shape``); :func:`place_state` puts a live
model's parameters and a fresh AdamW state on the bundle's placements and
:func:`place_like` any other input, after which ``bundle.step_fn`` runs.

The steps keep JAX's rules: ``remat`` "full" for train shapes; the
``grad_accum`` microbatches (global rows ``[i·B/µ, (i+1)·B/µ)``) summed in
a bf16 accumulator and divided by µ; the learning-rate scale
``warmup_cosine(step)`` at its defaults; ``m``, ``v`` and ``master``
placed like the parameters and ``step`` replicated.  As in the port's
trainer, a step updates the parameters and the state in place, and the
``params`` it takes are the model's own (:func:`place_state`'s).

The serve step decodes each rank's rows of the batch with the
parameters gathered whole: the decode path writes its caches in place,
which DTensor has no rule for.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ModelConfig, ShapeConfig, get_config, shape_by_name
from repro_torch.convert import flatten_tree, param_tree, tree_leaves, tree_map
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

from .sharding import (batch_sharding, cache_shardings, frontend_sharding, make_shard_act,
                       param_sharding_rules, pick_policy, to_placements)

__all__ = ["StepBundle", "build_train_step", "build_serve_step", "build_prefill_step",
           "make_model", "train_input_specs", "decode_input_specs", "place_state",
           "place_like", "gathered"]


@dataclass
class StepBundle:
    """Everything needed to run one (arch × shape × mesh) cell."""
    arch: str
    shape: ShapeConfig
    mesh: Any
    model: LM                 # the meta model; the live one after place_state
    step_fn: Any              # eager function of DTensors
    input_specs: dict         # meta DTensors of every input
    policy: str
    notes: dict


def make_model(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
               remat: str | None = None, attn_chunk: int = 512,
               rwkv_chunk: int = 16, kv_dtype: str = "bf16",
               policy: str = "fsdp_tp", param_dtype=torch.bfloat16,
               seed: int = 0, device="cuda") -> LM:
    """The cell's LM: remat "full" for train shapes unless given, the
    activation hook of ``mesh`` (none without one)."""
    if remat is None:
        remat = "full" if shape.kind == "train" else "none"
    shard_act = make_shard_act(mesh, policy) if mesh is not None else None
    return LM(cfg, param_dtype=param_dtype, attn_chunk=attn_chunk,
              max_seq=shape.seq_len + 8, remat=remat, shard_act=shard_act,
              rwkv_chunk=rwkv_chunk, kv_dtype=kv_dtype, seed=seed, device=device)


# ---------------------------------------------------------------------- #
# placements of tensors
# ---------------------------------------------------------------------- #
def _local_shape(shape, mesh, placements) -> list:
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide "
                                 f"mesh dim {i} of size {n}")
            out[p.dim] //= n
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _meta_spec(shape, dtype, mesh, placements) -> DTensor:
    """A meta DTensor of global ``shape``: nothing allocated."""
    local = torch.empty(_local_shape(shape, mesh, placements), dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _shard(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same on every rank) as a DTensor: each rank keeps its own
    slice, with no communication; on a mesh of one the tensor itself.  A
    DTensor already so placed is returned as it is."""
    if isinstance(t, DTensor):
        if t.device_mesh == mesh and tuple(t.placements) == tuple(placements):
            return t
        t = t.full_tensor()
    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=_contiguous_stride(t.shape))


def place_like(tensors, specs):
    """A tree of plain tensors (the same on every rank) as DTensors with the
    placements of the matching tree of ``specs``."""
    return tree_map(lambda t, s: _shard(t, s.device_mesh, s.placements), tensors, specs)


def _dtensors(tree, mesh, specs):
    """Meta DTensors of ``tree``'s leaves with the placements of ``specs``
    (a tree of the same structure holding one spec a leaf)."""
    return tree_map(lambda leaf, spec: _meta_spec(tuple(leaf.shape), leaf.dtype, mesh,
                                                  to_placements(spec, mesh)), tree, specs)


# ---------------------------------------------------------------------- #
# input specs (meta DTensors)
# ---------------------------------------------------------------------- #
def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      policy: str = "fsdp_tp") -> dict:
    b, s = shape.global_batch, shape.seq_len
    bsh = to_placements(batch_sharding(mesh, b, policy), mesh)
    batch = {"tokens": _meta_spec((b, s), torch.int32, mesh, bsh),
             "labels": _meta_spec((b, s), torch.int32, mesh, bsh)}
    if cfg.frontend_tokens:
        batch["frontend"] = _meta_spec(
            (b, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16, mesh,
            to_placements(frontend_sharding(mesh, b), mesh))
    return batch


def _prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta_spec((b, s), torch.int32, mesh,
                                  to_placements(batch_sharding(mesh, b), mesh))}
    if cfg.frontend_tokens:
        specs["frontend"] = _meta_spec(
            (b, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16, mesh,
            to_placements(frontend_sharding(mesh, b), mesh))
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, model: LM) -> dict:
    """serve_step inputs: one new token a row and the caches of seq_len
    (``model`` on the meta device: its caches allocate nothing)."""
    b, s = shape.global_batch, shape.seq_len
    cache = model.init_cache(b, s, dtype=torch.bfloat16)
    cspecs = cache_shardings(cache, mesh, b)
    specs = {"tokens": _meta_spec((b, 1), torch.int32, mesh,
                                  to_placements(batch_sharding(mesh, b), mesh)),
             "cache": _dtensors(cache, mesh, cspecs)}
    if cfg.frontend_tokens:
        specs["memory"] = _meta_spec(
            (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16, mesh,
            to_placements(frontend_sharding(mesh, b), mesh))
    return specs


def _param_specs(model: LM, mesh, policy: str) -> dict:
    tree = param_tree(model)
    return _dtensors(tree, mesh, param_sharding_rules(tree, mesh, policy))


# ---------------------------------------------------------------------- #
# live state
# ---------------------------------------------------------------------- #
def place_state(bundle: StepBundle, model: LM | None = None, *, seed: int = 0,
                device="cuda"):
    """Put a live model on the bundle's placements and make it the
    bundle's model: its parameters become DTensors (each rank keeps its
    slice; on a mesh of one, the same storage).  ``model`` defaults to a
    fresh one of the bundle's settings drawn from ``seed`` on ``device``.
    Returns (params, opt_state): the JAX-layout tree of the model's
    parameters and, for a train bundle, a fresh AdamW state placed like
    them (``step`` replicated); None for the other bundles.  The live
    model takes the meta model's settings, as set on ``bundle.model``
    (its ``param_dtype`` among them)."""
    meta = bundle.model
    if model is None:
        model = LM(meta.cfg, param_dtype=meta.param_dtype, attn_chunk=meta.attn_chunk,
                   mamba_chunk=meta.mamba_chunk, capacity_factor=meta.capacity_factor,
                   max_seq=meta.max_seq, rwkv_chunk=meta.rwkv_chunk, remat=meta.remat,
                   kv_dtype=meta.kv_dtype, seed=seed, device=device)
    model.shard_act = meta.shard_act
    model.remat = meta.remat
    train = "opt_state" in bundle.input_specs
    specs = flatten_tree(bundle.input_specs["params"])
    with torch.no_grad():
        for prefix, mod in list(model.named_modules()):
            for name, p in list(mod._parameters.items()):
                spec = specs[f"{prefix}.{name}" if prefix else name]
                mod._parameters[name] = nn.Parameter(
                    _shard(p.detach(), spec.device_mesh, spec.placements),
                    requires_grad=train)
    bundle.model = model
    params = param_tree(model)
    if not train:
        return params, None
    opt_state = adamw_init(params, bundle.notes["opt"].moment_dtype)
    return params, opt_state


@contextlib.contextmanager
def gathered(model: LM):
    """The model's parameters gathered whole (plain tensors) for the
    duration; on a mesh of one, the same storage."""
    saved = []
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if isinstance(p, DTensor):
                saved.append((mod, name, p))
                mod._parameters[name] = nn.Parameter(p.full_tensor(), requires_grad=False)
    try:
        yield model
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


# ---------------------------------------------------------------------- #
# step functions
# ---------------------------------------------------------------------- #
def build_train_step(arch: str, shape_name: str, mesh, *,
                     policy: str | None = None,
                     opt: AdamWConfig | None = None,
                     cfg: ModelConfig | None = None,
                     attn_chunk: int = 512,
                     rwkv_chunk: int = 16,
                     moment_dtype: str = "float32",
                     grad_accum: int = 1,
                     remat: str | None = None) -> StepBundle:
    """(params, opt_state, batch) -> (params, opt_state, metrics), in place.

    ``grad_accum`` > 1 splits the global batch into microbatches whose
    gradients are summed in bf16, as the JAX step does."""
    cfg = cfg or get_config(arch)
    shape = shape_by_name(shape_name)
    opt = opt or AdamWConfig(moment_dtype=moment_dtype)
    policy = policy or pick_policy(cfg.total_params())
    if shape.global_batch % grad_accum:
        raise ValueError("global batch not divisible by grad_accum")
    model = make_model(cfg, shape, mesh, remat=remat, policy=policy, attn_chunk=attn_chunk,
                       rwkv_chunk=rwkv_chunk, device="meta")
    pspecs = _param_specs(model, mesh, policy)
    ospecs = {"step": _meta_spec((), torch.int32, mesh, (Replicate(),) * mesh.ndim),
              "m": tree_map(lambda s: _retype(s, opt.moment_dtype), pspecs),
              "v": tree_map(lambda s: _retype(s, opt.moment_dtype), pspecs),
              "master": tree_map(lambda s: _retype(s, "float32"), pspecs)}
    micro = shape.global_batch // grad_accum

    def micro_batch(batch, i):
        """Rows [i·B/µ, (i+1)·B/µ) of the global batch, placed as a batch
        of B/µ."""
        out = {}
        for k, v in batch.items():
            part = v[i * micro:(i + 1) * micro]
            spec = (frontend_sharding(mesh, micro) if k == "frontend"
                    else batch_sharding(mesh, micro, policy))
            out[k] = part.redistribute(mesh, to_placements(spec, mesh))
        return out

    def train_step(params, opt_state, batch):
        model = bundle.model
        leaves = tree_leaves(params)
        if grad_accum == 1:
            loss = model.loss(batch)
            grads = list(torch.autograd.grad(loss, leaves))
        else:
            gsum = [torch.zeros_like(p, dtype=torch.bfloat16) for p in leaves]
            lsum = 0.0
            for i in range(grad_accum):
                l = model.loss(micro_batch(batch, i))
                g = torch.autograd.grad(l, leaves)
                gsum = [a + b.to(a.dtype) for a, b in zip(gsum, g)]
                lsum = lsum + l.detach()
            grads = [g / grad_accum for g in gsum]
            loss = lsum / grad_accum
        by_param = {id(p): _like(g, p) for p, g in zip(leaves, grads)}
        grads_tree = tree_map(lambda p: by_param[id(p)], params)
        lr_scale = warmup_cosine(opt_state["step"])
        params, opt_state, metrics = adamw_update(opt, params, grads_tree, opt_state, lr_scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    specs = {"params": pspecs, "opt_state": ospecs,
             "batch": train_input_specs(cfg, shape, mesh, policy)}
    bundle = StepBundle(arch, shape, mesh, model, train_step, specs, policy,
                        notes={"remat": model.remat, "opt": opt})
    return bundle


def _retype(spec: DTensor, dtype: str) -> DTensor:
    return _meta_spec(tuple(spec.shape), getattr(torch, dtype), spec.device_mesh,
                      spec.placements)


def _like(g, p):
    """The gradient on its parameter's placements: a weight used outside
    the regions (a norm's scale against a sequence-sharded input) comes
    back as a partial sum."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_serve_step(arch: str, shape_name: str, mesh, *,
                     policy: str | None = None,
                     cfg: ModelConfig | None = None,
                     attn_chunk: int = 512,
                     kv_dtype: str = "bf16") -> StepBundle:
    """serve_step(params, cache, tokens[, memory]) -> (logits [B, 1, V],
    cache): one token a row decoded against the caches at position
    seq_len - 1.  Each rank decodes its rows of the batch (the caches'
    other shards gathered for the step) with the parameters gathered
    whole, and the new caches come back on the caches' placements."""
    cfg = cfg or get_config(arch)
    shape = shape_by_name(shape_name)
    policy = policy or pick_policy(cfg.total_params())
    model = make_model(cfg, shape, mesh, remat="none", attn_chunk=attn_chunk,
                       kv_dtype=kv_dtype, device="meta")
    in_specs = decode_input_specs(cfg, shape, mesh, model)

    @torch.no_grad()
    def serve_step(params, cache, tokens, memory=None):
        model = bundle.model
        rows = [p if p == Shard(0) else Replicate() for p in tokens.placements]
        rows_of = lambda dim: [Shard(dim) if p == Shard(0) else p for p in rows]  # noqa: E731
        local = tree_map(lambda c: c.redistribute(mesh, rows_of(1)).to_local(), cache)
        mem = None if memory is None else memory.redistribute(mesh, rows).to_local()
        with gathered(model):
            logits, local = model.decode_step(
                local, tokens.redistribute(mesh, rows).to_local(), shape.seq_len - 1,
                memory=mem)
        new = tree_map(lambda t, c: DTensor.from_local(t, mesh, rows_of(1), run_check=False)
                       .redistribute(mesh, c.placements), local, cache)
        return DTensor.from_local(logits, mesh, rows_of(0), run_check=False), new

    specs = {"params": _param_specs(model, mesh, policy), **in_specs}
    bundle = StepBundle(arch, shape, mesh, model, serve_step, specs, policy, notes={})
    return bundle


def build_prefill_step(arch: str, shape_name: str, mesh, *,
                       policy: str | None = None,
                       cfg: ModelConfig | None = None,
                       attn_chunk: int = 512) -> StepBundle:
    """prefill(params, tokens[, frontend]) -> the last position's logits
    [B, V] (f32)."""
    cfg = cfg or get_config(arch)
    shape = shape_by_name(shape_name)
    policy = policy or pick_policy(cfg.total_params())
    model = make_model(cfg, shape, mesh, remat="none", attn_chunk=attn_chunk,
                       device="meta")

    @torch.no_grad()
    def prefill(params, tokens, frontend=None):
        return bundle.model.forward(tokens, frontend, last_only=True)[:, -1]

    specs = {"params": _param_specs(model, mesh, policy),
             **_prefill_input_specs(cfg, shape, mesh)}
    bundle = StepBundle(arch, shape, mesh, model, prefill, specs, policy, notes={})
    return bundle
