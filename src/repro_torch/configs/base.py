"""Architecture configuration for the PyTorch port.

The port's own copy of ``ModelConfig``, ``get_config`` and
``get_smoke_config`` from the JAX package's ``configs/base.py``: the
port imports nothing of that package.  ``ARCH_IDS`` lists the JAX
package's ten architectures in its order: the dense and MoE decoders,
RWKV6, the hybrid Mamba/attention model, the cross-attention VLM and the
encoder-decoder.
``ShapeConfig`` (a batch shape: sequence length, global batch, kind) is
copied too, with the named shapes ``SHAPES`` (a plain dict: callers may
register shapes of their own with ``SHAPES.setdefault``) and
``shape_by_name``.
Each module defines ``CONFIG`` (published dims) and ``smoke_config()``
(a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke_config", "shape_by_name"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- MoE ---------------------------------------------------------- #
    n_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1       # every p-th layer is MoE (jamba: 2)
    # --- hybrid (attention/SSM interleave) ----------------------------- #
    attn_layer_period: int = 0      # 0: all attn; p: layers p-1, 2p-1, ... attn
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- attention-free (rwkv) ----------------------------------------- #
    attention_free: bool = False
    # --- frontends / enc-dec ------------------------------------------- #
    n_encoder_layers: int = 0       # >0: encoder-decoder
    cross_attn_period: int = 0      # vlm: every p-th layer cross-attends
    frontend_tokens: int = 0        # stub frontend: #precomputed embeddings
    frontend_dim: int = 0           # stub frontend: embedding dim
    # --- misc ----------------------------------------------------------- #
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0         # 0: full attention
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """Kind of decoder layer ``i``: attn | mamba | rwkv."""
        if self.attention_free:
            return "rwkv"
        if self.attn_layer_period > 0:
            return (
                "attn"
                if (i % self.attn_layer_period) == self.attn_layer_period - 1
                else "mamba"
            )
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return (i % self.moe_layer_period) == self.moe_layer_period - 1

    def layer_cross_attends(self, i: int) -> bool:
        if self.cross_attn_period <= 0:
            return False
        return (i % self.cross_attn_period) == self.cross_attn_period - 1

    # ------------------------------------------------------------------ #
    # parameter counts (used by roofline + scheduler weights)
    # ------------------------------------------------------------------ #
    def attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def mamba_params(self) -> int:
        d = self.d_model
        d_in = self.mamba_expand * d
        # in_proj (x,z), conv, x_proj (dt,B,C), dt_proj, out_proj, A, D
        return (
            d * 2 * d_in
            + d_in * self.mamba_d_conv
            + d_in * (self.mamba_d_state * 2 + d_in // 16)
            + (d_in // 16) * d_in
            + d_in * d
            + d_in * self.mamba_d_state
            + d_in
        )

    def rwkv_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,o projections + data-dependent decay lora
        return 5 * d * d + 4 * d * 64

    def mlp_params(self, d_ff: int | None = None) -> int:
        f = d_ff if d_ff is not None else self.d_ff
        return 3 * self.d_model * f  # SwiGLU: gate, up, down

    def layer_params(self, i: int) -> int:
        kind = self.layer_kind(i)
        if kind == "attn":
            mix = self.attn_params()
        elif kind == "mamba":
            mix = self.mamba_params()
        else:
            mix = self.rwkv_params()
        if self.layer_is_moe(i):
            ffn = self.n_experts * self.mlp_params() + self.d_model * self.n_experts
        else:
            ffn = self.mlp_params()
        if self.layer_cross_attends(i):
            mix += self.attn_params()
        return mix + ffn + 2 * self.d_model  # + norms

    def total_params(self) -> int:
        p = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model  # lm head
        for i in range(self.n_layers):
            p += self.layer_params(i)
        if self.is_encdec:
            enc = replace(
                self, n_experts=0, cross_attn_period=0,
                n_encoder_layers=0, attention_free=False,
                attn_layer_period=0,
            )
            for i in range(self.n_encoder_layers):
                p += enc.layer_params(i)
        return p

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.total_params()
        p = self.total_params()
        for i in range(self.n_layers):
            if self.layer_is_moe(i):
                p -= (self.n_experts - self.experts_per_token) * self.mlp_params()
        return p


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "mixtral_8x7b",
    "olmoe_1b_7b",
    "minitron_4b",
    "granite_8b",
    "qwen25_32b",
    "llama3_8b",
    "rwkv6_1b6",
    "jamba_15_large",
    "llama32_vision_90b",
    "seamless_m4t_v2",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "mixtral-8x7b": "mixtral_8x7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "minitron-4b": "minitron_4b",
    "granite-8b": "granite_8b",
    "qwen2.5-32b": "qwen25_32b",
    "llama3-8b": "llama3_8b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "jamba-1.5-large-398b": "jamba_15_large",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
})


def _module(arch: str):
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shape_by_name(name: str) -> ShapeConfig:
    return SHAPES[name]
