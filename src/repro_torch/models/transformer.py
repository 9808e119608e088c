"""Decoder LM — port of ``repro/models/transformer.py``.

The port has the attention path with a dense FFN (llama3_8b,
granite_8b, minitron_4b, qwen25_32b) or a MoE one (olmoe_1b_7b,
mixtral_8x7b) and the attention-free RWKV6 path (rwkv6_1b6), each with
serving (``forward``, ``decode_step``; the attention cache in bf16 or,
with ``kv_dtype="int8"``, quantized) and the training loss (``loss``,
with ``remat`` "none", "full" or "dots").  Mamba, cross-attention and
encoder–decoder layers arrive with their own slices; a config that needs
them raises here.

The parameters keep the JAX tree's key paths and layouts, so weights
map 1:1 (:mod:`repro_torch.convert`): ``embed``, ``final_norm``,
``lm_head`` and ``blocks[j]``, each leaf stacked ``[n_rep, ...]`` over
the repeats of period position ``j``; weights are ``[in, out]`` and
applied as ``x @ W``.  ``jax.lax.scan`` over the stacked layers is a
Python loop over the repeats.  The parameters do not require grad, so
serving builds no graph; the trainer turns grad on for what it trains.
On the card, attention's gradient is the flash backward kernel and the
WKV recurrence's the WKV backward kernel.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import (Initializer, apply_rope, embed, resolve_device,
                     rms_norm, rope_frequencies, swiglu, unembed)

__all__ = ["LM", "LayerSpec"]


@dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn | mamba | rwkv
    moe: bool
    cross: bool


def _lcm(*vals: int) -> int:
    out = 1
    for v in vals:
        if v > 1:
            out = out * v // math.gcd(out, v)
    return out


def _later_slice(cfg: ModelConfig, spec: LayerSpec) -> str | None:
    """The port slice that brings what ``spec`` needs, or None if here."""
    if cfg.is_encdec or spec.cross:
        return "cross-attention / encoder-decoder"
    if spec.kind == "mamba":
        return "SSM"
    return None


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
    """Write ``layer`` into slot ``r`` of the stacked tree ``dst``."""
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
    KV chunk of the CPU attention scan and ``rwkv_chunk`` the chunk of
    the CPU WKV (:func:`repro_torch.models.rwkv.wkv_chunked`); on the
    card both run kernels.  ``capacity_factor`` sizes each expert's
    capacity in MoE layers (:func:`repro_torch.models.moe.moe_capacity`).
    ``max_seq`` sizes the RoPE table that decode reads (default 8192).
    ``remat`` is the activation checkpointing of each layer under a loss:
    "none" saves every layer's activations, "full" recomputes each layer
    in the backward pass (JAX's ``jax.checkpoint`` of the layer body),
    "dots" saves the outputs of the products without a batch dim and
    recomputes the rest (JAX's ``checkpoint_dots_with_no_batch_dims``).
    ``kv_dtype="int8"`` stores the attention decode cache quantized
    (per-token, per-head absmax scales); any other value keeps it in the
    cache's dtype, as in JAX.
    """

    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.bfloat16,
                 attn_chunk: int = 512, capacity_factor: float = 1.25,
                 max_seq: int = 0, rwkv_chunk: int = 16, remat: str = "none",
                 kv_dtype: str = "bf16", seed: int = 0,
                 device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', not {remat!r}")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.attn_chunk = attn_chunk
        self.capacity_factor = capacity_factor
        self.max_seq = max_seq or 8192
        self.rwkv_chunk = rwkv_chunk
        self.remat = remat
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
        for spec in self.specs:
            later = _later_slice(cfg, spec)
            if later:
                raise NotImplementedError(
                    f"{cfg.name}: {spec} layers are not ported yet; they "
                    f"arrive with the {later} slice")
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
        p = {"mixer": self._init_mixer(init, spec), "ffn_norm": init.ones((d,))}
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
        blocks = []
        for spec in self.specs:
            # filled repeat by repeat: no second copy of the stack
            stacked = None
            for r in range(self.n_rep):
                stacked = _stack_into(stacked, self._init_layer(init, spec),
                                      r, self.n_rep)
            blocks.append(_Tree(stacked))
        self.blocks = nn.ModuleList(blocks)

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

    def _self_attn(self, p, x, cos_sin, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        q = apply_rope(q, cos_sin, positions)
        k = apply_rope(k, cos_sin, positions)
        o = attn.gqa_attention(q, k, v, causal=True, chunk=self.attn_chunk,
                               sliding_window=cfg.sliding_window)
        o = o.reshape(b, s, cfg.n_heads * cfg.hd)
        return o @ p["wo"].to(x.dtype)

    def _ffn(self, p, spec, x):
        """(FFN output, MoE aux loss: 0.0 for a dense FFN)."""
        cfg = self.cfg
        h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        if spec.moe:
            return moe_mod.moe_ffn(p["moe"], h, top_k=cfg.experts_per_token,
                                   capacity_factor=self.capacity_factor)
        f = p["ffn"]
        return swiglu(h, f["w_gate"].to(x.dtype), f["w_up"].to(x.dtype),
                      f["w_down"].to(x.dtype)), 0.0

    def _layer_seq(self, p, spec, x, cos_sin, positions):
        """Full-sequence layer (prefill): (x, aux).  The JAX layer also
        returns its k/v, which prefill drops; so does this one."""
        cfg = self.cfg
        if spec.kind == "rwkv":
            h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
            x = x + rwkv_mod.rwkv_seq(p["mixer"], h, cfg.n_heads, cfg.hd,
                                      cfg.norm_eps, chunk=self.rwkv_chunk)
        else:
            x = x + self._self_attn(p["mixer"], x, cos_sin, positions)
        y, aux = self._ffn(p, spec, x)
        return x + y, aux

    # ------------------------------------------------------------------ #
    # forward (prefill logits)
    # ------------------------------------------------------------------ #
    def hidden_states(self, tokens: torch.Tensor):
        """(final-norm hidden states [B, S, d], MoE aux loss summed over
        the layers: 0.0 without MoE layers)."""
        x = embed(self.embed, tokens).to(self.param_dtype)
        s = x.shape[1]
        cos_sin = self._rope(max(s, 1))
        positions = torch.arange(s, device=x.device)[None, :]
        remat = {"full": {}, "dots": {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}}.get(self.remat)
        aux_total = 0.0
        # position-major like the JAX scan: every repeat of position 0,
        # then of position 1, ..., the aux summed in that order
        for spec, block in zip(self.specs, self.blocks):
            for r in range(self.n_rep):
                if remat is None:
                    x, aux = self._layer_seq(block.rep(r), spec, x, cos_sin, positions)
                else:
                    x, aux = checkpoint(self._rep_layer, block, r, spec, x, cos_sin,
                                        positions, use_reentrant=False, **remat)
                aux_total = aux_total + aux
        return rms_norm(x, self.final_norm, self.cfg.norm_eps), aux_total

    def _rep_layer(self, block, r, spec, x, cos_sin, positions):
        # the repeat's views are taken inside, so the checkpoint saves
        # none of them
        return self._layer_seq(block.rep(r), spec, x, cos_sin, positions)

    def forward(self, tokens: torch.Tensor, last_only: bool = False):
        """Causal logits [B, S, V] (f32). tokens: [B, S] int.

        ``last_only`` avoids materializing the [B, S, V] logits tensor —
        serving prefill only needs the final position.
        """
        x, _ = self.hidden_states(tokens)
        if last_only:
            x = x[:, -1:]
        return unembed(x, self._table())

    # ------------------------------------------------------------------ #
    # training loss
    # ------------------------------------------------------------------ #
    def loss(self, batch: dict, vocab_chunk: int = 512) -> torch.Tensor:
        """Next-token cross entropy (f32 scalar), chunked over the sequence
        so the [B, S, V] logits tensor is never resident.  batch:
        ``tokens`` and ``labels`` [B, S] int, optional ``mask`` [B, S].

        The JAX function's rules: ``vocab_chunk`` splits S only when it
        divides S (else one chunk of S); a missing mask counts every
        position and the divisor is at least 1; a label outside [0, V)
        matches no vocabulary entry (``jax.nn.one_hot`` gives a zero row),
        so its position adds the chunk's log-sum-exp alone; the MoE
        load-balancing loss, summed over the layers, is added at 0.01.
        Each chunk is checkpointed, as ``@jax.checkpoint`` does there, so
        no chunk's [B, c, V] logits are saved for the backward pass.
        """
        x, aux = self.hidden_states(batch["tokens"])
        labels = batch["labels"]
        table = self._table()
        b, s, _ = x.shape
        chunk = min(vocab_chunk, s)
        n_chunks = s // chunk if s % chunk == 0 else 1
        if s % chunk != 0:
            chunk = s
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
                if mask is None else mask.to(torch.float32))
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        denom = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            part = slice(c * chunk, (c + 1) * chunk)
            total = total + checkpoint(self._chunk_nll, x[:, part], labels[:, part],
                                       mask[:, part], table, use_reentrant=False)
            denom = denom + mask[:, part].sum()
        return total / torch.clamp(denom, min=1.0) + 0.01 * aux

    def _chunk_nll(self, x, labels, mask, table) -> torch.Tensor:
        """Masked sum of one chunk's next-token NLL (f32)."""
        logits = unembed(x, table)                              # [B, c, V] f32
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
        ``[n_rep, bsz, H, hd, hd]`` in f32 (``max_len`` does not enter).
        """
        cfg = self.cfg
        dtype = dtype or self.param_dtype
        caches = []
        for spec in self.specs:
            if spec.kind == "rwkv":
                one = rwkv_mod.init_rwkv_cache(bsz, cfg.d_model, cfg.n_heads,
                                               cfg.hd, dtype, self.device)
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

    def _layer_step(self, p, spec, x, cache, r, cos_sin, pos):
        """One-token layer step. x: [B,1,d]; pos: [B] cursor per row.

        Writes this step's entries into repeat ``r`` of the stacked
        ``cache`` in place: k/v at the cursor (quantized, with their
        scales, in an int8 cache), or RWKV's last input and state.
        """
        cfg = self.cfg
        if spec.kind == "rwkv":
            h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
            o, new = rwkv_mod.rwkv_step(
                p["mixer"], h, {name: t[r] for name, t in cache.items()},
                cfg.n_heads, cfg.hd, cfg.norm_eps)
            for name, t in new.items():
                cache[name][r].copy_(t)
            x = x + o
            return x + self._ffn(p, spec, x)[0]
        b = x.shape[0]
        h = rms_norm(x, p["mixer"]["norm"], cfg.norm_eps)
        q, k, v = self._qkv(p["mixer"], h)
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
        x = x + o @ p["mixer"]["wo"].to(x.dtype)
        # a MoE layer routes the [B, 1, d] step as JAX does: B groups of
        # one token, each expert's capacity 1
        return x + self._ffn(p, spec, x)[0]

    def decode_step(self, cache: list, tokens: torch.Tensor, pos):
        """Logits [B, 1, V] (f32) for one new token per row.

        tokens: [B, 1] int; pos: int (whole batch at one cursor) or [B]
        int tensor (continuous batching: per-slot cursors), the current
        cache length.  Unlike the JAX function, which returns a new
        cache, this writes ``cache`` in place and returns it.
        """
        x = embed(self.embed, tokens).to(self.param_dtype)
        pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
        for spec, block, c in zip(self.specs, self.blocks, cache):
            for r in range(self.n_rep):
                x = self._layer_step(block.rep(r), spec, x, c, r,
                                     self.cos_sin, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return unembed(x, self._table()), cache
