"""Mamba (selective S6) block — port of ``repro/models/ssm.py``.

The recurrence per channel c and state dim n::

    h_t = exp(A_c,n · dt_t,c) · h_{t-1} + dt_t,c · B_t,n · x_t,c
    y_t,c = Σ_n C_t,n · h_t,c,n + D_c · x_t,c

Sequence processing scans over *chunks* of ``chunk`` steps (default 256)
with the state in f32, as the JAX function does: S is padded to a chunk
multiple, each chunk runs an associative scan with JAX's combine
``(d1·d2, i1·d2 + i2)`` over its steps, and under grad each chunk is
checkpointed (``jax.checkpoint`` there), so the backward pass recomputes
a chunk's ``[B, L, d_in, N]`` trajectory instead of saving it.  Decode
keeps ``(conv state, ssm state)`` and advances one step.

JAX has no Pallas kernel for the scan, so this is plain torch on every
device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

__all__ = ["init_mamba", "mamba_seq", "mamba_step", "init_mamba_cache"]


def _dt_rank(d_model: int) -> int:
    return max(1, -(-d_model // 16))


def init_mamba(init, d_model: int, d_state: int, d_conv: int,
               expand: int) -> dict:
    d_in = expand * d_model
    r = _dt_rank(d_model)
    # S4D-real initialization: A = -(1..N), stored as log (f32, then cast)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=init.device))
    return {
        "in_proj": init.normal((d_model, 2 * d_in), fan_in=d_model),
        "conv_w": init.normal((d_conv, d_in), fan_in=d_conv),
        "conv_b": init.zeros((d_in,)),
        "x_proj": init.normal((d_in, r + 2 * d_state), fan_in=d_in),
        "dt_proj": init.normal((r, d_in), fan_in=r),
        "dt_bias": init.zeros((d_in,)),
        "a_log": a_log.expand(d_in, d_state).to(init.param_dtype).contiguous(),
        "d_skip": init.ones((d_in,)),
        "out_proj": init.normal((d_in, d_model), fan_in=d_in),
    }


def _ssm_params(params, xc):
    """Common projections. xc: [..., d_in] (post-conv, silu'd).

    The products come out in xc's dtype; dt (softplus in f32), a, b and c
    are f32."""
    r = params["dt_proj"].shape[0]
    n = params["a_log"].shape[1]
    proj = xc @ params["x_proj"].to(xc.dtype)
    dt_r, b, c = torch.split(proj, [r, n, n], dim=-1)
    dt = dt_r @ params["dt_proj"].to(xc.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())                  # [d_in, N]
    return dt, a, b.float(), c.float()


def _combine(e1, e2):
    d1, i1 = e1
    d2, i2 = e2
    return d1 * d2, i1 * d2 + i2


def _associative_scan(elems):
    """Inclusive scan of ``_combine`` over dim 1 of the pair ``elems``:
    ``jax.lax.associative_scan``'s own tree (pairs reduced, the half scanned
    recursively, the evens filled in and interleaved), so the products are
    formed in the reference's order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... over dim 1; a is as long as b or one longer."""
    m = b.shape[1]
    out = torch.stack([a[:, :m], b], dim=2).flatten(1, 2)
    return out if a.shape[1] == m else torch.cat([out, a[:, m:]], dim=1)


def _selective_scan_chunk(h0, dt, a, b, c, xc):
    """Associative scan within one chunk.

    h0: [B, d_in, N]; dt, xc: [B, L, d_in]; b, c: [B, L, N].
    Returns (y [B, L, d_in], hL).
    """
    # elementwise decay and input terms per step: [B, L, d_in, N]
    decay = torch.exp(dt[..., None] * a[None, None])
    inp = (dt * xc)[..., None] * b[:, :, None, :]
    dec_c, inp_c = _associative_scan([decay, inp])
    h = dec_c * h0[:, None] + inp_c                          # [B, L, d_in, N]
    y = torch.einsum("blin,bln->bli", h, c)
    return y, h[:, -1]


def mamba_seq(params: dict, x: torch.Tensor, chunk: int = 256,
              shard=None) -> torch.Tensor:
    """Full-sequence Mamba block. x: [B, S, d_model] -> same shape.

    ``shard(tensor, kind)`` is called where the JAX function pins the d_in
    dim of the scan's inputs ("mamba_din"); the default is the identity."""
    shard = shard or (lambda v, kind: v)
    btype = x.dtype
    bsz, s, _ = x.shape
    d_in = params["dt_bias"].shape[0]
    n = params["a_log"].shape[1]

    xz = x @ params["in_proj"].to(btype)
    xr, z = xz.chunk(2, dim=-1)
    xr = shard(xr, "mamba_din")

    # depthwise causal conv over the sequence: a sum of K products in the
    # activation dtype, in JAX's order
    w = params["conv_w"].to(btype)                           # [K, d_in]
    k = w.shape[0]
    xp = F.pad(xr, (0, 0, k - 1, 0))
    xc = sum(xp[:, i:i + s] * w[i] for i in range(k))
    xc = F.silu(xc + params["conv_b"].to(btype))

    dt, a, b, c = _ssm_params(params, xc)
    dt = shard(dt, "mamba_din")
    xcf = shard(xc.float(), "mamba_din")

    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    padded = [F.pad(t, (0, 0, 0, pad)) if pad else t for t in (dt, b, c, xcf)]

    h = torch.zeros((bsz, d_in, n), dtype=torch.float32, device=x.device)
    ys = []
    # a named range: profiles read the scan's device time under it
    with record_function("mamba_selective_scan"):
        for i in range(n_chunks):
            dt_k, b_k, c_k, x_k = (t[:, i * chunk:(i + 1) * chunk] for t in padded)
            args = (h, dt_k, a, b_k, c_k, x_k)
            if torch.is_grad_enabled():
                # the chunk's [B, L, d_in, N] trajectory is recomputed in
                # the backward pass from (h, inputs), not saved
                y_k, h = checkpoint(_selective_scan_chunk, *args, use_reentrant=False)
            else:
                y_k, h = _selective_scan_chunk(*args)
            ys.append(y_k)
        y = torch.cat(ys, dim=1)[:, :s]

    y = y + xcf * params["d_skip"].float()
    y = y.to(btype) * F.silu(z)
    return y @ params["out_proj"].to(btype)


def init_mamba_cache(bsz: int, d_model: int, d_state: int, d_conv: int,
                     expand: int, dtype=torch.float32, device="cuda") -> dict:
    """``conv`` [B, K-1, d_in] in ``dtype``; ``ssm`` [B, d_in, N] in f32."""
    d_in = expand * d_model
    return {
        "conv": torch.zeros((bsz, d_conv - 1, d_in), dtype=dtype, device=device),
        "ssm": torch.zeros((bsz, d_in, d_state), dtype=torch.float32, device=device),
    }


def mamba_step(params: dict, x: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
    """Single decode step. x: [B, 1, d_model].

    The conv cache is read in x's dtype and comes back in its own dtype;
    the ssm state stays f32."""
    btype = x.dtype
    xz = x @ params["in_proj"].to(btype)
    xr, z = xz.chunk(2, dim=-1)                              # [B,1,d_in]

    w = params["conv_w"].to(btype)
    window = torch.cat([cache["conv"].to(btype), xr], dim=1)
    xc = torch.einsum("bki,ki->bi", window, w)[:, None]
    xc = F.silu(xc + params["conv_b"].to(btype))

    dt, a, b, c = _ssm_params(params, xc)
    decay = torch.exp(dt[:, 0, :, None] * a[None])           # [B,d_in,N]
    inp = (dt[:, 0] * xc[:, 0].float())[..., None] * b[:, 0, None, :]
    h = cache["ssm"] * decay + inp
    y = torch.einsum("bin,bn->bi", h, c[:, 0])[:, None]
    y = y + xc.float() * params["d_skip"].float()
    y = y.to(btype) * F.silu(z)
    out = y @ params["out_proj"].to(btype)
    new_cache = {"conv": window[:, 1:].to(cache["conv"].dtype), "ssm": h}
    return out, new_cache
