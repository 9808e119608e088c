"""RWKV6 "Finch" block — port of ``repro/models/rwkv.py``.

Time-mix with data-dependent decay.  Per head (size ``hd``), with state
S ∈ R^{hd×hd}::

    out_t = r_t · (S + (u ⊙ k_t) v_tᵀ)
    S     = diag(w_t) S + k_t v_tᵀ,   w_t = exp(-exp(ww_t))

``ww_t`` is data-dependent (low-rank LoRA on the shifted input).

On CUDA tensors the recurrence runs the Hopper WKV kernel through
:func:`repro_torch.kernels.ops.rwkv_wkv`, for prefill (from a zero
state) and for each decode step (S = 1, from the cache's state).  On CPU
tensors prefill runs the ported chunked form :func:`wkv_chunked` and
decode :func:`wkv_scan_ref`, so the CPU numerics are the JAX model's.
The two forms agree to ``tests/test_wkv_chunked.py``'s 5e-4, not
bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import reference_wkv
from .layers import rms_norm

__all__ = ["init_rwkv", "rwkv_seq", "rwkv_step", "init_rwkv_cache",
           "wkv_chunked", "wkv_scan_ref"]

_LORA = 64


def init_rwkv(init, d_model: int, n_heads: int, head_dim: int) -> dict:
    """The JAX tree's time-mix parameters, drawn in its order."""
    dh = n_heads * head_dim
    return {
        "mix_r": init.ones((d_model,)) * 0.5,
        "mix_k": init.ones((d_model,)) * 0.5,
        "mix_v": init.ones((d_model,)) * 0.5,
        "mix_w": init.ones((d_model,)) * 0.5,
        "mix_g": init.ones((d_model,)) * 0.5,
        "w_r": init.normal((d_model, dh), fan_in=d_model),
        "w_k": init.normal((d_model, dh), fan_in=d_model),
        "w_v": init.normal((d_model, dh), fan_in=d_model),
        "w_g": init.normal((d_model, dh), fan_in=d_model),
        "w_o": init.normal((dh, d_model), fan_in=dh),
        # data-dependent decay LoRA
        "decay_a": init.normal((d_model, _LORA), fan_in=d_model),
        "decay_b": init.normal((_LORA, dh), fan_in=_LORA),
        "decay_base": init.zeros((dh,)),
        "bonus_u": init.normal((n_heads, head_dim), fan_in=head_dim),
        "ln_x": init.ones((dh,)),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / cache for t = 0)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _projections(params, x, x_prev, n_heads, head_dim):
    btype = x.dtype

    def mix(name):
        m = params[f"mix_{name}"].to(btype)
        return x * m + x_prev * (1.0 - m)

    b, s, _ = x.shape
    shp = (b, s, n_heads, head_dim)
    r = (mix("r") @ params["w_r"].to(btype)).reshape(shp)
    k = (mix("k") @ params["w_k"].to(btype)).reshape(shp)
    v = (mix("v") @ params["w_v"].to(btype)).reshape(shp)
    g = mix("g") @ params["w_g"].to(btype)
    ww = mix("w") @ params["decay_a"].to(btype)
    ww = torch.tanh(ww) @ params["decay_b"].to(btype)
    ww = ww.float() + params["decay_base"].float()
    # decay in (0, 1), f32; per-step log-decay clamped to >= -8 as in the
    # JAX model (a channel decaying below e^-8 per step is dead after
    # two steps regardless)
    w = torch.exp(-torch.clamp(torch.exp(ww), max=8.0)).reshape(shp)
    return r, k, v, g, w


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 16):
    """Chunked (GLA-style) WKV — the JAX model's sequence formulation.

    Equal to :func:`wkv_scan_ref` up to f32 rounding (property-tested),
    processing the sequence in chunks of ``chunk`` steps with matmuls
    and carrying the state once per chunk.  Within a chunk, pairwise
    decay factors are computed in log space around the chunk's midpoint,
    so every intermediate is bounded by e^(8·chunk/2); per-step
    log-decays are clamped to >= -8.  r,k,v,w: [B, S, H, hd]; w = decay
    in (0, 1).  Returns (out [B,S,H,hd] in r's dtype, sT f32).
    """
    b, s, h, hd = r.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    rf, kf, vf = (t.float() for t in (r, k, v))
    lw = torch.clamp(torch.log(torch.clamp(w.float(), min=1e-38)), min=-8.0)
    if pad:
        rf, kf, vf, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf, lw))
    resh = lambda t: t.reshape(b, nc, chunk, h, hd)  # noqa: E731
    rc, kc, vc, lwc = resh(rf), resh(kf), resh(vf), resh(lw)
    uf = u.float()
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    mid = chunk // 2
    outs = []
    for c in range(nc):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]   # [B, C, H, hd]
        la = torch.cumsum(lwb, dim=1)             # la_t = Σ_{1..t} log w
        la_prev = la - lwb                        # la_{t-1}
        ref = la[:, mid]                          # [B, H, hd]
        rt = rb * torch.exp(la_prev - ref[:, None])
        kt = kb * torch.exp(ref[:, None] - la)
        # pairwise coefficients A[t, τ] = Σ_i r̃_t k̃_τ, strictly causal
        a = torch.tril(torch.einsum("bthi,bzhi->bhtz", rt, kt), diagonal=-1)
        intra = torch.einsum("bhtz,bzhj->bthj", a, vb)
        cross = torch.einsum("bthi,bhij->bthj", rb * torch.exp(la_prev), state)
        diag = torch.einsum("bthi,hi,bthi->bth", rb, uf, kb)
        outs.append(cross + intra + diag[..., None] * vb)
        la_end = la[:, -1]                        # [B, H, hd]
        state = (torch.exp(la_end)[..., None] * state
                 + torch.einsum("bthi,bthj->bhij",
                                kb * torch.exp(la_end[:, None] - la), vb))
    out = torch.stack(outs, dim=1).reshape(b, nc * chunk, h, hd)
    return out[:, :s].to(r.dtype), state


def wkv_scan_ref(r, k, v, w, u, s0=None):
    """Sequential WKV recurrence: the JAX model's decode step.

    r,k,v,w: [B, S, H, hd]; u: [H, hd].  Returns (out [B,S,H,hd] in f32,
    sT).  State S: [B, H, hd(key), hd(value)], f32.  The same step as the
    kernels' oracle :func:`repro_torch.kernels.ref.reference_wkv`, in
    model layout and on f32 inputs.
    """
    b, s, h, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    tr = lambda t: t.float().transpose(1, 2)  # noqa: E731
    out, sT = reference_wkv(tr(r), tr(k), tr(v), tr(w), u, s0)
    return out.transpose(1, 2), sT


def rwkv_seq(params: dict, x: torch.Tensor, n_heads: int, head_dim: int,
             norm_eps: float = 1e-5, chunk: int = 16) -> torch.Tensor:
    """Full-sequence RWKV6 time-mix from a zero state. x: [B, S, d_model].

    CUDA tensors run the WKV kernel; CPU tensors :func:`wkv_chunked`
    with ``chunk``.  The final state is dropped, as in the JAX model.
    """
    btype = x.dtype
    b, s, _ = x.shape
    r, k, v, g, w = _projections(params, x, _shift(x), n_heads, head_dim)
    if x.device.type == "cpu":
        out, _ = wkv_chunked(r, k, v, w, params["bonus_u"], chunk=chunk)
    else:
        out, _ = ops.rwkv_wkv(r, k, v, w, params["bonus_u"])
    out = out.reshape(b, s, n_heads * head_dim).to(btype)
    out = rms_norm(out, params["ln_x"], norm_eps)
    out = out * F.silu(g)
    return out @ params["w_o"].to(btype)


def init_rwkv_cache(bsz: int, d_model: int, n_heads: int, head_dim: int,
                    dtype=torch.float32, device="cuda") -> dict:
    """``last_x`` [B, d] in ``dtype``; ``state`` [B, H, hd, hd] in f32."""
    return {
        "last_x": torch.zeros((bsz, d_model), dtype=dtype, device=device),
        "state": torch.zeros((bsz, n_heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
    }


def rwkv_step(params: dict, x: torch.Tensor, cache: dict, n_heads: int,
              head_dim: int, norm_eps: float = 1e-5
              ) -> tuple[torch.Tensor, dict]:
    """Single decode step. x: [B, 1, d_model].  Returns (y, new cache).

    CUDA tensors run the WKV kernel at S = 1 from ``cache["state"]``;
    CPU tensors :func:`wkv_scan_ref`.  ``cache`` is not written: the new
    cache holds fresh tensors.
    """
    btype = x.dtype
    b = x.shape[0]
    x_prev = cache["last_x"][:, None].to(btype)
    r, k, v, g, w = _projections(params, x, x_prev, n_heads, head_dim)
    if x.device.type == "cpu":
        out, s_new = wkv_scan_ref(r, k, v, w, params["bonus_u"], s0=cache["state"])
    else:
        out, s_new = ops.rwkv_wkv(r, k, v, w, params["bonus_u"], s0=cache["state"])
    out = out.reshape(b, 1, n_heads * head_dim).to(btype)
    out = rms_norm(out, params["ln_x"], norm_eps)
    out = out * F.silu(g)
    y = out @ params["w_o"].to(btype)
    return y, {"last_x": x[:, 0].to(cache["last_x"].dtype), "state": s_new}
