"""Decoder LM — port of ``repro/models/transformer.py``.

One ``LM`` class dispatches per-layer kinds from ``ModelConfig``, as the
JAX one does:

* dense / MoE decoders (llama3_8b, granite_8b, minitron_4b, qwen25_32b,
  olmoe_1b_7b, mixtral_8x7b),
* attention-free RWKV6 (rwkv6_1b6),
* hybrid Mamba/attention with MoE (jamba_15_large),
* a decoder with periodic cross-attention to stub patch embeddings
  (llama32_vision_90b),
* encoder–decoder with cross-attention in every decoder layer
  (seamless_m4t_v2; stub frame embeddings feed the encoder),

each with serving (``forward``, ``decode_step``, ``encode_memory``; the
attention cache in bf16 or, with ``kv_dtype="int8"``, quantized) and the
training loss (``loss``, with ``remat`` "none", "full" or "dots").

The parameters keep the JAX tree's key paths and layouts, so weights
map 1:1 (:mod:`repro_torch.convert`): ``embed``, ``final_norm``,
``lm_head`` and ``blocks[j]``, each leaf stacked ``[n_rep, ...]`` over
the repeats of period position ``j``; for enc-dec archs ``encoder``
(stacked ``[n_encoder_layers, ...]``) and ``enc_norm``; ``frontend_proj``
where the frontend's width is not d_model.  Weights are ``[in, out]`` and
applied as ``x @ W``.  ``jax.lax.scan`` over the stacked layers is a
Python loop over the repeats.  The parameters do not require grad, so
serving builds no graph; the trainer turns grad on for what it trains.
On the card, attention's gradient is the flash backward kernel and the
WKV recurrence's the WKV backward kernel.

With DTensor parameters and inputs (a step of
:mod:`repro_torch.launch.steps`) the same code runs on a device mesh.
``shard_act(x, kind)`` is called where the JAX model calls its hook, the
norms and the residual stream run on DTensors, and every block that
reads weights runs in a local region (:mod:`repro_torch.models.shards`):
attention's projections and kernel with the heads split over "model"
where the head counts allow, every other block over the batch's shards
with its weights gathered whole.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .shards import batch_placements, is_dtensor, on_shards, split_on_model
from .layers import (Initializer, apply_rope, embed, resolve_device,
                     rms_norm, rope_frequencies, swiglu, unembed)

__all__ = ["LM", "LayerSpec"]


@dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn | mamba | rwkv
    moe: bool
    cross: bool


_ENC_SPEC = LayerSpec("attn", False, False)     # an encoder layer


def _lcm(*vals: int) -> int:
    out = 1
    for v in vals:
        if v > 1:
            out = out * v // math.gcd(out, v)
    return out


# JAX's ``checkpoint_dots_with_no_batch_dims``: the products without a
# batch dim (``x @ W`` on a [B, S, d] x folds its leading dims and runs as
# ``aten.mm``) are saved; everything else, ``aten.bmm`` (attention's
# score and value products on the CPU, the MoE expert products with the
# expert as batch dim) and the flash kernel included, is recomputed.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization over hd: (int8 values,
    bf16 scales of ``[..., 1]``).  The values are rounded (half to even,
    as ``jnp.round``) against the f32 scale; only the stored scale is
    rounded to bf16, as in the JAX function."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.round(xf / scale)
    return torch.clamp(q, -127, 127).to(torch.int8), scale.to(torch.bfloat16)


class _Tree(nn.Module):
    """A nested dict of parameters under the JAX tree's key names."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, _Tree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def rep(self, r: int) -> dict:
        """Views of repeat ``r`` of every stacked leaf, as a plain dict."""
        out = {name: p[r] for name, p in self._parameters.items()}
        out.update({name: m.rep(r) for name, m in self._modules.items()})
        return out


def _stack_into(dst: dict | None, layer: dict, r: int, n_rep: int) -> dict:
    """Write ``layer`` into slot ``r`` of the stacked tree ``dst``.  A stack
    of one repeat is the layer itself, viewed with a leading dim of 1: no
    copy (a full-width jamba MoE layer is 19 GB in bf16)."""
    if n_rep == 1:
        return {k: (_stack_into(None, v, r, 1) if isinstance(v, dict) else v[None])
                for k, v in layer.items()}
    if dst is None:
        dst = {k: (_stack_into(None, v, r, n_rep) if isinstance(v, dict)
                   else v.new_empty((n_rep,) + tuple(v.shape)))
               for k, v in layer.items()}
    for k, v in layer.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, r, n_rep)
        else:
            dst[k][r].copy_(v)
    return dst


class LM(nn.Module):
    """Decoder LM holding its parameters on ``device``.

    Parameters are drawn at construction from the port's
    :class:`Initializer` seeded with ``seed`` (load other weights with
    :func:`repro_torch.convert.load_jax_params`).  ``attn_chunk`` is the
    KV chunk of the CPU attention scan (and of cross-attention on every
    device) and ``rwkv_chunk`` the chunk of the CPU WKV
    (:func:`repro_torch.models.rwkv.wkv_chunked`); on the card both
    self-attention and WKV run kernels.  ``mamba_chunk`` is the chunk of
    the Mamba selective scan (:func:`repro_torch.models.ssm.mamba_seq`).
    ``capacity_factor`` sizes each expert's capacity in MoE layers
    (:func:`repro_torch.models.moe.moe_capacity`).
    ``max_seq`` sizes the RoPE table that decode reads (default 8192).
    ``remat`` is the activation checkpointing of each layer under a loss:
    "none" saves every layer's activations, "full" recomputes each layer
    in the backward pass (JAX's ``jax.checkpoint`` of the layer body),
    "dots" saves the outputs of the products without a batch dim and
    recomputes the rest (JAX's ``checkpoint_dots_with_no_batch_dims``).
    ``kv_dtype="int8"`` stores the attention decode cache quantized
    (per-token, per-head absmax scales); any other value keeps it in the
    cache's dtype, as in JAX.  ``shard_act(x, kind)`` is the JAX model's
    activation hook, called at its sites with its kinds ("attn_in",
    "residual", "logits"; "mamba_din", "moe_tokens" and "moe_hidden"
    inside the Mamba and MoE layers); None is the identity.
    ``device="meta"`` builds every parameter as an empty meta tensor of
    its shape and dtype, drawing nothing (the port's ``jax.eval_shape``).
    """

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.bfloat16,
                 attn_chunk: int = 512, mamba_chunk: int = 256,
                 capacity_factor: float = 1.25,
                 max_seq: int = 0, rwkv_chunk: int = 16, remat: str = "none",
                 shard_act=None, kv_dtype: str = "bf16", seed: int = 0,
                 device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', not {remat!r}")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.attn_chunk = attn_chunk
        self.mamba_chunk = mamba_chunk
        self.capacity_factor = capacity_factor
        self.max_seq = max_seq or 8192
        self.rwkv_chunk = rwkv_chunk
        self.remat = remat
        self.shard_act = shard_act or (lambda x, kind="act": x)
        self.kv_dtype = kv_dtype

        p = _lcm(
            cfg.attn_layer_period or 1,
            cfg.moe_layer_period if cfg.is_moe else 1,
            cfg.cross_attn_period or 1,
        )
        if cfg.n_layers % p != 0:
            p = cfg.n_layers  # fall back to fully unrolled stack
        self.period = p
        self.n_rep = cfg.n_layers // p
        self.specs = [self._spec(j) for j in range(p)]
        self.init_params(seed, device)
        # Built once here: the JAX decode_step rebuilds the same f32
        # table for max_seq on every call.
        self.register_buffer(
            "cos_sin", rope_frequencies(cfg.hd, self.max_seq, cfg.rope_theta,
                                        device), persistent=False)

    def _spec(self, j: int) -> LayerSpec:
        cfg = self.cfg
        cross = cfg.layer_cross_attends(j) or cfg.is_encdec
        return LayerSpec(cfg.layer_kind(j), cfg.layer_is_moe(j), cross)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ #
    # init: the JAX ``init`` tree, drawn in the same order
    # ------------------------------------------------------------------ #
    def _init_mixer(self, init: Initializer, spec: LayerSpec) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        if spec.kind == "rwkv":
            return {"norm": init.ones((d,)),
                    **rwkv_mod.init_rwkv(init, d, cfg.n_heads, hd)}
        if spec.kind == "mamba":
            return {"norm": init.ones((d,)),
                    **ssm_mod.init_mamba(init, d, cfg.mamba_d_state,
                                         cfg.mamba_d_conv, cfg.mamba_expand)}
        mixer = {
            "norm": init.ones((d,)),
            "wq": init.normal((d, cfg.n_heads * hd), fan_in=d),
            "wk": init.normal((d, cfg.n_kv_heads * hd), fan_in=d),
            "wv": init.normal((d, cfg.n_kv_heads * hd), fan_in=d),
            "wo": init.normal((cfg.n_heads * hd, d), fan_in=cfg.n_heads * hd),
        }
        if cfg.qkv_bias:
            mixer["bq"] = init.zeros((cfg.n_heads * hd,))
            mixer["bk"] = init.zeros((cfg.n_kv_heads * hd,))
            mixer["bv"] = init.zeros((cfg.n_kv_heads * hd,))
        return mixer

    def _init_layer(self, init: Initializer, spec: LayerSpec) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        p = {"mixer": self._init_mixer(init, spec)}
        if spec.cross:
            p["cross"] = {
                "norm": init.ones((d,)),
                "wq": init.normal((d, cfg.n_heads * cfg.hd), fan_in=d),
                "wk": init.normal((d, cfg.n_kv_heads * cfg.hd), fan_in=d),
                "wv": init.normal((d, cfg.n_kv_heads * cfg.hd), fan_in=d),
                "wo": init.normal((cfg.n_heads * cfg.hd, d), fan_in=cfg.n_heads * cfg.hd),
            }
        p["ffn_norm"] = init.ones((d,))
        if spec.moe:
            p["moe"] = moe_mod.init_moe(init, d, cfg.d_ff, cfg.n_experts)
        else:
            p["ffn"] = {
                "w_gate": init.normal((d, cfg.d_ff), fan_in=d),
                "w_up": init.normal((d, cfg.d_ff), fan_in=d),
                "w_down": init.normal((cfg.d_ff, d), fan_in=cfg.d_ff),
            }
        return p

    def init_params(self, seed: int, device=None) -> None:
        """Draw every parameter anew from ``seed``, as construction does
        (the JAX ``LM.init(seed)``); they do not require grad."""
        self._init_params(Initializer(seed, self.param_dtype,
                                      device or self.device))

    def _init_params(self, init: Initializer) -> None:
        cfg = self.cfg
        param = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.embed = param(init.normal((cfg.vocab_size, cfg.d_model),
                                       fan_in=cfg.d_model))
        self.final_norm = param(init.ones((cfg.d_model,)))
        if not cfg.tie_embeddings:
            self.lm_head = param(init.normal((cfg.vocab_size, cfg.d_model),
                                             fan_in=cfg.d_model))
        self.blocks = nn.ModuleList(
            self._init_stack(init, spec, self.n_rep) for spec in self.specs)
        if cfg.is_encdec:
            # encoder: a plain non-causal attention stack
            self.encoder = self._init_stack(init, _ENC_SPEC, cfg.n_encoder_layers)
            self.enc_norm = param(init.ones((cfg.d_model,)))
        if cfg.frontend_tokens and cfg.frontend_dim != cfg.d_model:
            self.frontend_proj = param(init.normal((cfg.frontend_dim, cfg.d_model),
                                                   fan_in=cfg.frontend_dim))

    def _init_stack(self, init: Initializer, spec: LayerSpec, n: int) -> _Tree:
        # filled repeat by repeat: no second copy of the stack
        stacked = None
        for r in range(n):
            stacked = _stack_into(stacked, self._init_layer(init, spec), r, n)
        return _Tree(stacked)

    def _table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    # ------------------------------------------------------------------ #
    # building blocks
    # ------------------------------------------------------------------ #
    def _rope(self, max_pos: int) -> torch.Tensor:
        if max_pos <= self.cos_sin.shape[1]:
            return self.cos_sin      # rows < max_pos equal a fresh table's
        return rope_frequencies(self.cfg.hd, max_pos, self.cfg.rope_theta,
                                self.device)

    def _qkv(self, p: dict, h: torch.Tensor):
        cfg = self.cfg
        b, s, _ = h.shape
        q = h @ p["wq"].to(h.dtype)
        k = h @ p["wk"].to(h.dtype)
        v = h @ p["wv"].to(h.dtype)
        if cfg.qkv_bias:
            q = q + p["bq"].to(h.dtype)
            k = k + p["bk"].to(h.dtype)
            v = v + p["bv"].to(h.dtype)
        return (q.reshape(b, s, cfg.n_heads, cfg.hd),
                k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
                v.reshape(b, s, cfg.n_kv_heads, cfg.hd))

    def _self_attn(self, p, x, cos_sin, positions, causal=True):
        cfg = self.cfg
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        if x.shape[1] > 1:
            h = self.shard_act(h, "attn_in")

        def attend(q, k, v):
            q = apply_rope(q, cos_sin, positions)
            k = apply_rope(k, cos_sin, positions)
            return attn.gqa_attention(q, k, v, causal=causal, chunk=self.attn_chunk,
                                      sliding_window=cfg.sliding_window)
        return self._out_proj(p, self._heads(p, h, h, attend))

    def _cross_attn(self, p, x, memory):
        """memory: [B, M, d] (frontend embeddings / encoder output), its K
        and V computed anew at every call (decode steps included), as in
        JAX."""
        h = rms_norm(x, p["norm"], self.cfg.norm_eps)
        return self._out_proj(p, self._heads(
            p, h, memory,
            lambda q, k, v: attn.cross_attention(q, k, v, chunk=self.attn_chunk)))

    def _heads(self, p, h, src, fn):
        """``fn(q, k, v)`` of [B, S, H, hd] tensors, q projected from h and k,
        v from ``src`` (h itself for self-attention); its result flat
        [B, S, Hq*hd].  On DTensors, a local region with the batch where h
        holds it and the heads split over "model" where both head counts
        divide it (the projections' columns and biases split with them);
        elsewhere every rank holds every head, since a local q head could
        not find its kv head."""
        cfg = self.cfg
        names = [n for n in ("wq", "wk", "wv", "bq", "bk", "bv") if n in p]

        def local(h, src, *weights):
            w = dict(zip(names, weights))
            q = h @ w["wq"].to(h.dtype)
            k = src @ w["wk"].to(h.dtype)
            v = src @ w["wv"].to(h.dtype)
            if "bq" in w:
                q = q + w["bq"].to(h.dtype)
                k = k + w["bk"].to(h.dtype)
                v = v + w["bv"].to(h.dtype)
            heads = (t.unflatten(-1, (-1, cfg.hd)) for t in (q, k, v))
            return fn(*heads).flatten(2)
        if not is_dtensor(h):
            return local(h, src, *(p[n] for n in names))
        pl = batch_placements(h)
        out = split_on_model(pl, h, 2, cfg.n_heads, cfg.n_kv_heads)
        cols = [Shard(1) if q == Shard(2) else Replicate() for q in out]
        bias = [Shard(0) if q == Shard(2) else Replicate() for q in out]
        return on_shards(local, [(h, pl), (src, pl)] + [
            (p[n], cols if n.startswith("w") else bias) for n in names], out)

    def _out_proj(self, p, o):
        return self._per_batch(lambda o, w: o @ w["wo"].to(o.dtype), o, {"wo": p["wo"]})

    def _per_batch(self, fn, x, weights: dict, *others, outputs=None):
        """``fn(x, weights, *others)``; on DTensors, in a local region over
        x's batch shards (``others`` split as x is), the rest of every
        input whole on every rank and every weight gathered whole.  The
        result is split as x is; where ``fn`` returns a tuple, ``outputs``
        names each entry "batch" (so split) or "share" (each rank's share
        of a sum over the batch: ``Partial`` where the batch is split)."""
        if not is_dtensor(x):
            return fn(x, weights, *others)
        names = list(weights)
        pl = batch_placements(x)
        whole = [Replicate()] * len(pl)
        share = [Partial() if q == Shard(0) else Replicate() for q in pl]

        def local(x, *rest):
            return fn(x, dict(zip(names, rest)), *rest[len(names):])
        kinds = {"batch": pl, "share": share}
        out = pl if outputs is None else tuple(kinds[k] for k in outputs)
        return on_shards(local, [(x, pl)] + [(weights[n], whole) for n in names]
                         + [(o, pl) for o in others], out)

    def _ffn(self, p, spec, x):
        """(FFN output, MoE aux loss: 0.0 for a dense FFN)."""
        cfg = self.cfg
        h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        if spec.moe:
            return self._moe(p["moe"], h)
        return self._per_batch(lambda h, f: swiglu(h, f["w_gate"].to(h.dtype),
                                                   f["w_up"].to(h.dtype),
                                                   f["w_down"].to(h.dtype)),
                               h, p["ffn"]), 0.0

    def _moe(self, p, h):
        """The MoE layer, over the batch's shards (its groups) on DTensors,
        every expert on every rank: the routing's sorts and gathers stay
        local.  The aux loss, a mean over the groups, comes back as each
        rank's share of it (its local mean weighted by its groups)."""
        groups = h.shape[0]

        def run(h, w):
            y, aux = moe_mod.moe_ffn(w, h, top_k=self.cfg.experts_per_token,
                                     capacity_factor=self.capacity_factor,
                                     shard=self.shard_act)
            return y, aux * (h.shape[0] / groups)
        return self._per_batch(run, h, p, outputs=("batch", "share"))

    def _layer_seq(self, p, spec, x, memory, cos_sin, positions):
        """Full-sequence layer (prefill): (x, aux).  The JAX layer also
        returns its k/v, which prefill drops; so does this one.  A cross
        layer given no memory skips its cross-attention, as in JAX."""
        cfg = self.cfg
        shard = self.shard_act
        mixer = {k: v for k, v in p["mixer"].items() if k != "norm"}
        if spec.kind == "attn":
            # the partial sums pinned to the residual's placement before
            # the add, as JAX pins them
            x = x + shard(self._self_attn(p["mixer"], x, cos_sin, positions), "residual")
        elif spec.kind == "mamba":
            h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
            x = x + self._per_batch(lambda h, w: ssm_mod.mamba_seq(
                w, h, chunk=self.mamba_chunk, shard=shard), h, mixer)
        else:  # rwkv
            h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
            x = x + self._per_batch(lambda h, w: rwkv_mod.rwkv_seq(
                w, h, cfg.n_heads, cfg.hd, cfg.norm_eps, chunk=self.rwkv_chunk), h, mixer)
        if spec.cross and memory is not None:
            x = x + shard(self._cross_attn(p["cross"], x, memory), "residual")
        y, aux = self._ffn(p, spec, x)
        return x + shard(y, "residual"), aux

    # ------------------------------------------------------------------ #
    # forward (prefill logits)
    # ------------------------------------------------------------------ #
    def _remat(self) -> dict | None:
        """``checkpoint`` keywords of the layer policy (None: no checkpoint)."""
        return {"full": {}, "dots": {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}}.get(self.remat)

    def _frontend_memory(self, frontend, dtype):
        if frontend is None:
            return None
        mem = frontend.to(dtype)
        proj = getattr(self, "frontend_proj", None)
        if proj is None:
            return mem
        return self._per_batch(lambda m, w: m @ w["proj"].to(dtype), mem, {"proj": proj})

    def _encode(self, memory):
        """Encoder stack over frontend embeddings (enc-dec archs): each
        layer non-causal self-attention and a dense FFN, under the layer
        policy of ``remat``."""
        m = memory.shape[1]
        cos_sin = self._rope(m)
        positions = torch.arange(m, device=memory.device)[None, :]
        remat = self._remat()
        x = memory
        for r in range(self.cfg.n_encoder_layers):
            if remat is None:
                x = self._enc_layer(r, x, cos_sin, positions)
            else:
                x = checkpoint(self._enc_layer, r, x, cos_sin, positions,
                               use_reentrant=False, **remat)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def _enc_layer(self, r, x, cos_sin, positions):
        lp = self.encoder.rep(r)
        x = x + self.shard_act(self._self_attn(lp["mixer"], x, cos_sin, positions,
                                               causal=False), "residual")
        return self.shard_act(x + self._ffn(lp, _ENC_SPEC, x)[0], "residual")

    def hidden_states(self, tokens: torch.Tensor, frontend=None):
        """(final-norm hidden states [B, S, d], MoE aux loss summed over
        the layers: 0.0 without MoE layers).  ``frontend`` [B, M,
        frontend_dim]: the stub embeddings that cross layers attend to
        (through the encoder in enc-dec archs); without it they skip
        their cross-attention."""
        x = self._per_batch(lambda t, w: embed(w["embed"], t), tokens,
                            {"embed": self.embed}).to(self.param_dtype)
        memory = self._frontend_memory(frontend, x.dtype)
        if self.cfg.is_encdec and memory is not None:
            memory = self._encode(memory)
        s = x.shape[1]
        cos_sin = self._rope(max(s, 1))
        positions = torch.arange(s, device=x.device)[None, :]
        remat = self._remat()
        aux_total = 0.0
        # position-major like the JAX scan: every repeat of position 0,
        # then of position 1, ..., the aux summed in that order
        for spec, block in zip(self.specs, self.blocks):
            for r in range(self.n_rep):
                if remat is None:
                    x, aux = self._layer_seq(block.rep(r), spec, x, memory, cos_sin,
                                             positions)
                else:
                    x, aux = checkpoint(self._rep_layer, block, r, spec, x, memory,
                                        cos_sin, positions, use_reentrant=False, **remat)
                x = self.shard_act(x, "residual")
                aux_total = aux_total + aux
        return rms_norm(x, self.final_norm, self.cfg.norm_eps), aux_total

    def _rep_layer(self, block, r, spec, x, memory, cos_sin, positions):
        # the repeat's views are taken inside, so the checkpoint saves
        # none of them
        return self._layer_seq(block.rep(r), spec, x, memory, cos_sin, positions)

    def forward(self, tokens: torch.Tensor, frontend=None, last_only: bool = False):
        """Causal logits [B, S, V] (f32). tokens: [B, S] int; ``frontend``
        as for :meth:`hidden_states`.

        ``last_only`` avoids materializing the [B, S, V] logits tensor —
        serving prefill only needs the final position.
        """
        x, _ = self.hidden_states(tokens, frontend)

        def head(x, w):
            return unembed(x[:, -1:] if last_only else x, w["table"])
        return self.shard_act(self._per_batch(head, x, {"table": self._table()}), "logits")

    # ------------------------------------------------------------------ #
    # training loss
    # ------------------------------------------------------------------ #
    def loss(self, batch: dict, vocab_chunk: int = 512) -> torch.Tensor:
        """Next-token cross entropy (f32 scalar), chunked over the sequence
        so the [B, S, V] logits tensor is never resident.  batch:
        ``tokens`` and ``labels`` [B, S] int, optional ``mask`` [B, S] and
        ``frontend`` [B, M, frontend_dim] (see :meth:`hidden_states`).

        The JAX function's rules: ``vocab_chunk`` splits S only when it
        divides S (else one chunk of S); a missing mask counts every
        position and the divisor is at least 1; a label outside [0, V)
        matches no vocabulary entry (``jax.nn.one_hot`` gives a zero row),
        so its position adds the chunk's log-sum-exp alone; the MoE
        load-balancing loss, summed over the layers, is added at 0.01.
        Each chunk is checkpointed, as ``@jax.checkpoint`` does there, so
        no chunk's [B, c, V] logits are saved for the backward pass.
        """
        x, aux = self.hidden_states(batch["tokens"], batch.get("frontend"))
        labels = batch["labels"]
        mask = batch.get("mask")
        mask = (torch.ones_like(labels, dtype=torch.float32)
                if mask is None else mask.to(torch.float32))
        total, denom = self._nll_sums(x, labels, mask, vocab_chunk)
        return total / torch.clamp(denom, min=1.0) + 0.01 * aux

    def _nll_sums(self, x, labels, mask, vocab_chunk: int):
        """(masked NLL sum, mask sum) in f32; on DTensors, each rank's
        share of them, over its batch shard, with the table gathered."""
        def sums(x, w, labels, mask):
            b, s, _ = x.shape
            chunk = min(vocab_chunk, s)
            n_chunks = s // chunk if s % chunk == 0 else 1
            if s % chunk != 0:
                chunk = s
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            denom = torch.zeros((), dtype=torch.float32, device=x.device)
            for c in range(n_chunks):
                part = slice(c * chunk, (c + 1) * chunk)
                total = total + checkpoint(self._chunk_nll, x[:, part], labels[:, part],
                                           mask[:, part], w["table"], use_reentrant=False)
                denom = denom + mask[:, part].sum()
            return total, denom
        return self._per_batch(sums, x, {"table": self._table()}, labels, mask,
                               outputs=("share", "share"))

    def _chunk_nll(self, x, labels, mask, table) -> torch.Tensor:
        """Masked sum of one chunk's next-token NLL (f32)."""
        logits = self.shard_act(unembed(x, table), "logits")    # [B, c, V] f32
        lse = torch.logsumexp(logits, dim=-1)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (labels[..., None] == vocab).to(self.param_dtype)
        # JAX's einsum of f32 logits with the param-dtype one-hot: promoted
        # to f32, every entry but the label's multiplied by zero
        picked = (logits * onehot).sum(dim=-1)
        return ((lse - picked) * mask).sum()

    # ------------------------------------------------------------------ #
    # serving: decode
    # ------------------------------------------------------------------ #
    def init_cache(self, bsz: int, max_len: int, dtype=None) -> list:
        """Stacked per-position caches mirroring ``blocks``.

        Attention positions: ``{"k", "v"}`` of ``[n_rep, bsz, max_len,
        Hkv, hd]`` in ``dtype``; with ``kv_dtype="int8"``, int8 ``k``/``v``
        of that shape and bf16 ``k_scale``/``v_scale`` of ``[..., 1]``
        (``dtype`` does not apply to them).  RWKV positions:
        ``{"last_x", "state"}`` of ``[n_rep, bsz, d]`` in ``dtype`` and
        ``[n_rep, bsz, H, hd, hd]`` in f32; Mamba positions: ``{"conv",
        "ssm"}`` of ``[n_rep, bsz, d_conv - 1, d_in]`` in ``dtype`` and
        ``[n_rep, bsz, d_in, d_state]`` in f32 (``max_len`` does not enter
        either).  Cross layers keep no cache: their K/V come from the
        memory at every step.
        """
        cfg = self.cfg
        dtype = dtype or self.param_dtype
        caches = []
        for spec in self.specs:
            if spec.kind != "attn":
                one = (rwkv_mod.init_rwkv_cache(bsz, cfg.d_model, cfg.n_heads, cfg.hd,
                                                dtype, self.device)
                       if spec.kind == "rwkv" else
                       ssm_mod.init_mamba_cache(bsz, cfg.d_model, cfg.mamba_d_state,
                                                cfg.mamba_d_conv, cfg.mamba_expand,
                                                dtype, self.device))
                caches.append({name: t.expand((self.n_rep,) + t.shape).contiguous()
                               for name, t in one.items()})
                continue
            shape = (self.n_rep, bsz, max_len, cfg.n_kv_heads, cfg.hd)
            zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=self.device)  # noqa: E731
            if self.kv_dtype == "int8":
                sshape = shape[:-1] + (1,)
                caches.append({"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                               "k_scale": zeros(sshape, torch.bfloat16),
                               "v_scale": zeros(sshape, torch.bfloat16)})
            else:
                caches.append({"k": zeros(shape, dtype), "v": zeros(shape, dtype)})
        return caches

    def _layer_step(self, p, spec, x, cache, r, cos_sin, pos, memory):
        """One-token layer step. x: [B,1,d]; pos: [B] cursor per row.

        Writes this step's entries into repeat ``r`` of the stacked
        ``cache`` in place: k/v at the cursor (quantized, with their
        scales, in an int8 cache), RWKV's last input and state, or Mamba's
        conv window and state.  A cross layer given no memory skips its
        cross-attention, as in JAX.
        """
        cfg = self.cfg
        if spec.kind == "attn":
            x = x + self._attn_step(p["mixer"], x, cache, r, cos_sin, pos)
        else:
            h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
            mine = {name: t[r] for name, t in cache.items()}
            if spec.kind == "rwkv":
                o, new = rwkv_mod.rwkv_step(p["mixer"], h, mine, cfg.n_heads, cfg.hd,
                                            cfg.norm_eps)
            else:
                o, new = ssm_mod.mamba_step(p["mixer"], h, mine)
            for name, t in new.items():
                cache[name][r].copy_(t)
            x = x + o
        if spec.cross and memory is not None:
            x = x + self._cross_attn(p["cross"], x, memory)
        # a MoE layer routes the [B, 1, d] step as JAX does: B groups of
        # one token, each expert's capacity 1
        return x + self._ffn(p, spec, x)[0]

    def _attn_step(self, p, x, cache, r, cos_sin, pos):
        """Self-attention of one token over the cache; writes its k/v."""
        cfg = self.cfg
        b = x.shape[0]
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        positions = pos[:, None]
        q = apply_rope(q, cos_sin, positions)
        k = apply_rope(k, cos_sin, positions)
        # dynamic_update_slice clamps the start into the cache; so does
        # this.  The cache may be f32 under a bf16 model (ServeLoop): the
        # value is cast to the cache's dtype, as JAX's update casts it.
        rows = torch.arange(b, device=x.device)
        slot = pos.clamp(0, cache["k"].shape[2] - 1)
        quantized = "k_scale" in cache     # an int8 cache
        new = {"k": k, "v": v}
        if quantized:
            for name in ("k", "v"):
                new[name], new[f"{name}_scale"] = _quantize_kv(new[name])
        for name, val in new.items():
            cache[name][r][rows, slot] = val[:, 0].to(cache[name].dtype)
        k_cache, v_cache = cache["k"][r], cache["v"][r]
        if quantized:
            # the whole cache dequantized in the model dtype, as JAX does
            k_cache = k_cache.to(x.dtype) * cache["k_scale"][r].to(x.dtype)
            v_cache = v_cache.to(x.dtype) * cache["v_scale"][r].to(x.dtype)
        o = attn.decode_attention(q, k_cache, v_cache, pos + 1,
                                  sliding_window=cfg.sliding_window)
        o = o.reshape(b, 1, cfg.n_heads * cfg.hd)
        return o @ p["wo"].to(x.dtype)

    def decode_step(self, cache: list, tokens: torch.Tensor, pos, memory=None):
        """Logits [B, 1, V] (f32) for one new token per row.

        tokens: [B, 1] int; pos: int (whole batch at one cursor) or [B]
        int tensor (continuous batching: per-slot cursors), the current
        cache length.  ``memory``: optional [B, M, d] cross-attention
        memory (:meth:`encode_memory`), already projected/encoded.  Unlike
        the JAX function, which returns a new cache, this writes ``cache``
        in place and returns it.
        """
        x = embed(self.embed, tokens).to(self.param_dtype)
        pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
        for spec, block, c in zip(self.specs, self.blocks, cache):
            for r in range(self.n_rep):
                x = self._layer_step(block.rep(r), spec, x, c, r,
                                     self.cos_sin, pos, memory)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return unembed(x, self._table()), cache

    def encode_memory(self, frontend):
        """Cross-attention memory [B, M, d] of a request batch's ``frontend``
        (None: None), prepared once: projected where the config says so,
        then through the encoder in enc-dec archs."""
        mem = self._frontend_memory(frontend, self.param_dtype)
        if mem is not None and self.cfg.is_encdec:
            mem = self._encode(mem)
        return mem
