"""The cells' weights, made on the device from ``--seed``.

Each leaf of the decoder is drawn in the type it is served in, one
layer's slice at a time, from a generator seeded by (seed, leaf name,
layer): so the program's model and the plain reference get the same
numbers, and the reference can draw any one layer again on its own
without the program.  Matrices are fan-in scaled normals; norm gains are
1 + 0.1 N(0, 1), so that a gain the program forgets shows.

Leaf names are the decoder's tree paths: ``embed``, ``lm_head``,
``final_norm`` and, stacked over layers, ``blocks.0.mixer.{norm,wq,wk,
wv,wo}``, ``blocks.0.ffn_norm`` and ``blocks.0.moe.{router,w_gate,
w_up,w_down}``.
"""
from __future__ import annotations

import hashlib

import torch

__all__ = ["DTYPES", "draw", "leaf_seed", "layer_shapes", "top_shapes", "fill_model"]


# the configuration files' names of the types weights are served in
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_seed(seed: int, name: str, layer: int | None) -> int:
    """A 63-bit generator seed for one leaf's slice of one layer."""
    key = f"{int(seed)}/{name}/{-1 if layer is None else int(layer)}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def _is_gain(name: str) -> bool:
    return name.endswith("norm")


def draw(seed: int, name: str, layer: int | None, shape, dtype, device) -> torch.Tensor:
    """Leaf ``name``'s slice of ``layer`` (None for a leaf outside the
    stack), of ``shape``, drawn in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name, layer))
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    if _is_gain(name):
        return x.mul_(0.1).add_(1.0)
    fan_in = shape[-1] if name in ("embed", "lm_head") else shape[-2]
    return x.mul_(float(fan_in) ** -0.5)


def layer_shapes(m: dict) -> dict:
    """One layer's leaves and shapes, for the sizes ``m`` of a
    ``configs/*.json`` ``model`` (every layer attention and MoE)."""
    d, f, e = m["d_model"], m["d_ff"], m["n_experts"]
    hd = m.get("head_dim") or d // m["n_heads"]
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return {
        "blocks.0.mixer.norm": (d,), "blocks.0.mixer.wq": (d, hq),
        "blocks.0.mixer.wk": (d, hkv), "blocks.0.mixer.wv": (d, hkv),
        "blocks.0.mixer.wo": (hq, d), "blocks.0.ffn_norm": (d,),
        "blocks.0.moe.router": (d, e), "blocks.0.moe.w_gate": (e, d, f),
        "blocks.0.moe.w_up": (e, d, f), "blocks.0.moe.w_down": (e, f, d),
    }


def top_shapes(m: dict) -> dict:
    """The leaves outside the layer stack."""
    return {"embed": (m["vocab_size"], m["d_model"]), "final_norm": (m["d_model"],),
            "lm_head": (m["vocab_size"], m["d_model"])}


@torch.no_grad()
def fill_model(named_params, seed: int) -> int:
    """Draw every parameter of ``named_params`` ((name, tensor) pairs of a
    model whose storage is allocated) in place; stacked ``blocks.*`` leaves
    layer by layer.  Returns the number of elements drawn."""
    n = 0
    for name, p in named_params:
        if name.startswith("blocks."):
            for r in range(p.shape[0]):
                p[r].copy_(draw(seed, name, r, p.shape[1:], p.dtype, p.device))
        else:
            p.copy_(draw(seed, name, None, p.shape, p.dtype, p.device))
        n += p.numel()
    return n
