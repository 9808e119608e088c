"""Shared model building blocks — port of ``repro/models/layers.py``.

Functions take and return ``torch.Tensor``s; weights are ``[in, out]``
and applied as ``x @ W``, the JAX layout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "resolve_device",
    "Initializer",
    "rms_norm",
    "swiglu",
    "rope_frequencies",
    "apply_rope",
    "embed",
    "unembed",
]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises.

    There is no silent CPU run: callers that want the CPU say so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return device


class Initializer:
    """Deterministic fan-in scaled normal init from a ``torch.Generator``.

    ``jax.random`` streams cannot be reproduced in torch, so the port's
    init draws its own numbers; parity with JAX comes from carrying
    weights across (:func:`repro_torch.convert.load_jax_params`).

    On the ``"meta"`` device (the port's ``jax.eval_shape``) it draws
    nothing and makes no generator: every leaf is an empty meta tensor of
    the shape and dtype a real draw would have.
    """

    def __init__(self, seed: int, param_dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def normal(self, shape, fan_in: int | None = None, scale: float = 1.0):
        if self.gen is None:
            return torch.empty(shape, dtype=self.param_dtype, device=self.device)
        fan = fan_in if fan_in is not None else shape[0]
        std = scale / np.sqrt(max(fan, 1))
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        # scaled in place: a full-width jamba expert leaf is 12.9 GB in f32
        return x.mul_(std).to(self.param_dtype)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.param_dtype, device=self.device)

    def ones(self, shape):
        return torch.ones(shape, dtype=self.param_dtype, device=self.device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 accumulation."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ Wg) * (x @ Wu)) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_frequencies(head_dim: int, max_pos: int, theta: float,
                     device="cuda") -> torch.Tensor:
    """[2, max_pos, head_dim//2] cos/sin table (f32).

    Built in numpy float64 and cast once, as the JAX package builds it,
    so both tables hold the same f32 values.  On the ``"meta"`` device
    it is an empty table of that shape.
    """
    if torch.device(device).type == "meta":
        return torch.empty((2, max_pos, head_dim // 2), device="meta")
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    pos = np.arange(max_pos)
    ang = np.einsum("p,f->pf", pos, inv)
    table = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.from_numpy(table).to(resolve_device(device))


def apply_rope(x: torch.Tensor, cos_sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., S, H, hd]`` by per-position angles.

    ``positions [..., S]`` are absolute token positions.  Positions past
    the table are clamped to its last row, as a JAX gather clamps them.
    """
    positions = positions.clamp(max=cos_sin.shape[1] - 1)
    cos = cos_sin[0][positions][..., None, :]   # broadcast over heads
    sin = cos_sin[1][positions][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``, with ``jnp.take``'s index rules.

    ``jnp.take`` wraps indices in ``[-V, 0)`` and fills rows of indices
    outside ``[-V, V)`` with NaN, where torch indexing would raise (or,
    on the card, trap).  The port keeps the reference's rule.
    """
    v = table.shape[0]
    idx = torch.where(tokens < 0, tokens + v, tokens)
    valid = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, v - 1)]
    return torch.where(valid[..., None], rows, rows.new_tensor(float("nan")))


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocabulary logits (f32)."""
    return (x @ table.T).float()
