"""RWKV6 WKV recurrence — wrapper of the Hopper kernels in
``csrc/rwkv_wkv.cu``, the port of the Pallas TPU kernel
``repro/kernels/rwkv_wkv.py::wkv_bhsd``.

:func:`wkv_bhsd` keeps the TPU kernel's contract — r/k/v/w
``[B,H,S,hd]``, u ``[H,hd]``, s0 ``[B,H,hd,hd]``; returns (out in r's
dtype, the final state in f32) — without its ``S % chunk == 0``
restriction and ``chunk`` argument, which were artefacts of the TPU's
tiling: any S >= 1 runs, and S = 1 is one decode step.  r/k/v/w may be
strided views with a unit stride over hd (the model's ``[B,S,H,hd]``
tensors transposed), read in place; out is allocated in r's layout.  On
CPU tensors it runs :func:`wkv_bhsd_plain`; on CUDA tensors it launches
one of two kernels, picked by :func:`kernel_variant`, or raises — there
is no fallback, neither to the plain version nor from one kernel to the
other:

* ``"chunked"``: bf16 r/k/v at hd 64 with S >= :data:`CHUNKED_MIN_SEQ`,
  f32 or bf16 w; chunks of 16 steps on the tensor cores, f32 operands
  split into bf16 parts so the result stays the f32 recurrence's;
* ``"sequential"``: every other call it takes (f32 r/k/v, hd 8-32, short
  S such as the S = 1 decode step), one step at a time on the CUDA cores.

When grad mode is on and an input requires grad, the CUDA call is a
:class:`torch.autograd.Function`: its forward launches the kernel above
and saves only the inputs, and its gradient (:func:`wkv_bhsd_bwd`) is one
of two backward kernels, picked by :func:`backward_variant` by the rule
of :func:`kernel_variant`, again with no fallback:

* ``"backward_chunked"`` where the forward is ``"chunked"``: the state
  chain and the gradient chain over 16-step chunks on the tensor cores,
  then every (b, h, chunk) on its own on the CUDA cores;
* ``"backward"`` for the rest: one warp per 32 rows or columns walking
  all of S, the state recomputed from checkpoints it writes itself.

The TPU kernel has no backward; JAX differentiates its jnp model path.
Meta tensors (the dry run) take the CUDA path's checks and allocations,
and in place of each launch the kernel's work goes to :func:`cost.record`;
no kernel runs and no launch is counted.
:func:`wkv_bhsd_bwd_plain` and :func:`wkv_bhsd_bwd_chunked_plain` rehearse
the two backward kernels' arithmetic in torch for the CPU tests; the
plain gradient the card is held against is autograd of
:func:`wkv_bhsd_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cost
from ._build import load_library
from .ref import check_wkv_shapes, reference_wkv

__all__ = ["wkv_bhsd", "wkv_bhsd_bwd", "wkv_bhsd_bwd_chunked_plain", "wkv_bhsd_bwd_plain",
           "wkv_bhsd_plain", "backward_variant", "kernel_variant", "launch",
           "launch_backward", "reset_launch_counts", "BWD_CHUNK",
           "CHUNKED_HEAD_DIM", "CHUNKED_MIN_SEQ", "KERNEL_HEAD_DIMS", "VARIANTS"]

KERNEL_HEAD_DIMS = (8, 16, 32, 64)
CHUNKED_HEAD_DIM = 64
# Shortest S that the chunked kernel serves; below it the sequential
# kernel is as fast or faster (chip_smoke.py's wkv_choice rows, PERF.md).
CHUNKED_MIN_SEQ = 16
# Steps between the backward kernels' checkpoints (kBwdChunk and kC in
# csrc/rwkv_wkv.cu): the ``"backward"`` kernel's row blocks recompute a
# chunk's states from one; ``"backward_chunked"`` chains states and
# gradients over chunks of this length.
BWD_CHUNK = 16
# the two forward kernels and the two backward ones, each counted on its own
VARIANTS = ("chunked", "sequential", "backward", "backward_chunked")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {"chunked": "repro_wkv_fwd_chunked", "sequential": "repro_wkv_fwd",
          "backward": "repro_wkv_bwd", "backward_chunked": "repro_wkv_bwd_chunked"}
# the plain version is the oracle itself: one plain WKV in the port
wkv_bhsd_plain = reference_wkv


def kernel_variant(dtype: torch.dtype, w_dtype: torch.dtype, hd: int, s: int) -> str:
    """The kernel that serves a CUDA call of r/k/v ``dtype``, w ``w_dtype``,
    head dim ``hd`` and length ``s``."""
    chunked = (dtype == torch.bfloat16 and w_dtype in _KERNEL_DTYPES
               and hd == CHUNKED_HEAD_DIM and s >= CHUNKED_MIN_SEQ)
    return "chunked" if chunked else "sequential"


def backward_variant(dtype: torch.dtype, w_dtype: torch.dtype, hd: int, s: int) -> str:
    """The backward kernel that serves a CUDA call under grad: the
    chunk-parallel one exactly where :func:`kernel_variant` picks the
    chunked forward."""
    chunked = kernel_variant(dtype, w_dtype, hd, s) == "chunked"
    return "backward_chunked" if chunked else "backward"


@functools.lru_cache(maxsize=None)
def _kernel(variant: str):
    fn = getattr(load_library("rwkv_wkv"), _ENTRY[variant])
    # pointers and the stream as c_void_p, strides as 64-bit: ctypes would
    # otherwise pass Python ints as 32-bit C ints and cut them.
    # Forward: 8 pointers, (batch, heads, seq, hd), two sets of strides,
    # then the flags (bf16_rkv, bf16_w) or, for the chunked kernel, bf16_w
    # alone.  Backward: 15 pointers (16 for the chunk-parallel one), (batch,
    # heads, seq, hd), three sets of strides (inputs, dout, gradients),
    # (bf16_rkv, bf16_w) or bf16_w alone.
    n_ptr, n_strides = {"backward": (15, 9), "backward_chunked": (16, 9)}.get(variant, (8, 6))
    flags = 1 if variant in ("chunked", "backward_chunked") else 2
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * n_strides + [ctypes.c_int] * flags
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(B, H, S) strides in elements; 0 for a dim of size 1, whose stride
    no element reads."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


def launch(variant: str, r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``variant`` on checked CUDA inputs; counts nothing.
    On meta inputs it allocates the outputs and records the work
    (:func:`cost.record`) instead.

    :func:`wkv_bhsd` checks and counts; ``chip_smoke.py`` calls this to
    time a kernel on inputs the wrapper would give the other one."""
    b, h, s, hd = r.shape
    out = torch.empty_like(r)
    sT = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        cost.record(f"wkv_bhsd[{variant}]", cost.wkv_flops(b, h, s, hd),
                    cost.wkv_bytes(b, h, s, hd, r.element_size(), w.element_size()), "f32")
        return out, sT
    flags = ((int(w.dtype == torch.bfloat16),) if variant == "chunked"
             else (int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel(variant)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), out.data_ptr(), sT.data_ptr(), b, h, s, hd,
            *_strides(r), *_strides(out), *flags, stream)
    if err != 0:
        raise RuntimeError(f"WKV {variant} kernel launch failed: cudaError_t {err}")
    return out, sT


def _aligned16(t: torch.Tensor) -> bool:
    """Base and (B, H, S) strides on 16-byte boundaries, as cp.async needs."""
    return t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                          for st in _strides(t))


def _check_cuda(r, k, v, w, u, s0) -> str:
    """Raise unless the kernels take these CUDA (or meta) tensors; the
    forward variant."""
    devices = {t.device for t in (r, k, v, w, u, s0)}
    meta = devices == {torch.device("meta")}
    if not meta and (len(devices) != 1 or r.device.type != "cuda"):
        raise ValueError(f"r, k, v, w, u, s0 must all be on one CUDA device or all "
                         f"on the CPU; got {sorted(map(str, devices))}")
    b, h, s, hd = r.shape
    for name, t in (("r/k/v", r), ("w", w), ("u", u)):
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"kernel takes {name} in float32 or bfloat16, not {t.dtype}")
    if s0.dtype != torch.float32:
        raise ValueError(f"kernel takes a float32 s0, not {s0.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, not {hd}")
    if s == 0 or b * h == 0:
        raise ValueError(f"kernel takes S >= 1 and B*H >= 1, not {tuple(r.shape)}")
    if not s0.is_contiguous() or any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("kernel takes a contiguous s0 and r, k, v, w contiguous "
                         "over hd (unit stride)")
    if len({_strides(t) for t in (r, k, v, w)}) != 1:
        raise ValueError("kernel takes r, k, v, w in one layout (equal strides); got "
                         f"{[t.stride() for t in (r, k, v, w)]}")
    variant = kernel_variant(r.dtype, w.dtype, hd, s)
    if variant == "chunked" and not meta and not all(_aligned16(t) for t in (r, k, v, w)):
        raise ValueError("the chunked kernel takes r, k, v, w at 16-byte-aligned bases "
                         "and strides (cp.async); got a view off that alignment")
    return variant


def _count(variant: str) -> None:
    wkv_bhsd.variant_launches[variant] += 1
    wkv_bhsd.launches += 1


def _forward(r, k, v, w, u, s0):
    """(out, sT) from one counted launch on CUDA tensors, checked here."""
    variant = _check_cuda(r, k, v, w, u, s0)
    out, sT = launch(variant, r, k, v, w, u.float().contiguous(), s0)
    if r.device.type != "meta":
        _count(variant)
    return out, sT


def launch_backward(variant: str, r, k, v, w, u, s0, dout, dsT=None):
    """One launch of the backward kernel ``variant`` on checked CUDA inputs
    (dout with a unit stride over hd, 16-byte aligned for
    ``"backward_chunked"``; dsT f32 contiguous or None); counts nothing.

    :func:`wkv_bhsd_bwd` checks, picks and counts; ``chip_smoke.py`` and
    the card tests call this to run the ``"backward"`` kernel on inputs the
    wrapper gives the other one.  On meta inputs it allocates what the
    kernel writes and records the work instead.  Returns what
    :func:`wkv_bhsd_bwd` returns."""
    b, h, s, hd = r.shape
    dr = torch.empty_like(r)
    dk, dv = (torch.empty_strided(r.shape, dr.stride(), dtype=r.dtype, device=r.device)
              for _ in range(2))
    dw = torch.empty_strided(r.shape, dr.stride(), dtype=w.dtype, device=r.device)
    ds0 = torch.empty_like(s0)
    f32 = dict(dtype=torch.float32, device=r.device)
    if variant == "backward_chunked":
        n_chunks = -(-s // BWD_CHUNK)
        du = torch.empty((b, h, n_chunks, hd), **f32)          # per batch row and chunk
        # the state before every chunk, the gradient after it
        scratch = [torch.empty((b * h * n_chunks * hd * hd,), **f32) for _ in range(2)]
        flags = (int(w.dtype == torch.bfloat16),)
    else:
        du = torch.empty((b, h, hd), **f32)                    # per batch row
        n_ckpt = (s - 1) // BWD_CHUNK      # states after steps C, 2C, ... before S
        scratch = [torch.empty((max(b * h * n_ckpt * hd * hd, 1),), **f32)]
        flags = (int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    uf = u.float().contiguous()
    if r.device.type == "meta":
        cost.record(f"wkv_bhsd_bwd[{variant}]", cost.wkv_bwd_flops(b, h, s, hd),
                    cost.wkv_bwd_bytes(b, h, s, hd, r.element_size(), w.element_size()), "f32")
        du = du.sum((0, 2)) if variant == "backward_chunked" else du.sum(0)
        return dr, dk, dv, dw, du.to(u.dtype), ds0
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel(variant)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uf.data_ptr(),
            s0.data_ptr(), dout.data_ptr(), None if dsT is None else dsT.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), *(t.data_ptr() for t in scratch), b, h, s, hd, *_strides(r),
            *_strides(dout), *_strides(dr), *flags, stream)
    if err != 0:
        raise RuntimeError(f"WKV {variant} kernel launch failed: cudaError_t {err}")
    du = du.sum((0, 2)) if variant == "backward_chunked" else du.sum(0)
    return dr, dk, dv, dw, du.to(u.dtype), ds0


def wkv_bhsd_bwd(r, k, v, w, u, s0, dout, dsT=None):
    """(dr, dk, dv, dw, du, ds0) of :func:`wkv_bhsd` at its inputs for the
    output gradient ``dout`` and the final state's ``dsT`` (f32, None for
    zero): one launch of the backward kernel :func:`backward_variant`
    picks, counted.

    It takes what the forward kernels take, and ``dout`` of r's shape and
    dtype in any layout: a view without a unit stride over hd, or (for the
    chunk-parallel kernel, whose cp.async loads need them) off 16-byte
    bases and strides, is copied first (counted in
    ``wkv_bhsd.dout_copies``).  dr, dk and dv come in r's dtype and dw in
    w's, all four in r's layout where r is dense (as the forward allocates
    out); du in u's dtype; ds0 f32."""
    _check_cuda(r, k, v, w, u, s0)
    b, h, s, hd = r.shape
    variant = backward_variant(r.dtype, w.dtype, hd, s)
    if dout.shape != r.shape or dout.dtype != r.dtype or dout.device != r.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match r "
                         f"{tuple(r.shape)} {r.dtype}")
    meta = r.device.type == "meta"
    if dout.stride(3) != 1 or (variant == "backward_chunked" and not meta
                               and not _aligned16(dout)):
        # a copy, also of a contiguous view off alignment (.contiguous()
        # would return that view)
        dout = dout.clone(memory_format=torch.contiguous_format)
        if not meta:
            wkv_bhsd.dout_copies += 1
    if dsT is not None:
        if dsT.shape != s0.shape or dsT.device != r.device:
            raise ValueError(f"dsT {tuple(dsT.shape)} does not match s0 {tuple(s0.shape)}")
        dsT = dsT.float().contiguous()
    grads = launch_backward(variant, r, k, v, w, u, s0, dout, dsT)
    if not meta:
        _count(variant)
    return grads


def wkv_bhsd_bwd_plain(r, k, v, w, u, s0, dout, dsT=None):
    """The backward kernel's arithmetic in torch (f32), for the CPU tests.

    Per (b, h), with S_t the state before step t and G_t = dL/dS_t
    (G_S = dsT):

    * row sweep, forward: S from s0; dr_t = S_t·dout_t + u ⊙ k_t (v_t·dout_t),
      du += r_t ⊙ k_t (v_t·dout_t); S_t kept at every :data:`BWD_CHUNK`-th
      step;
    * row sweep, backward, chunk by chunk from the last: the chunk's states
      recomputed from its checkpoint, then dw_t = rowsum(G_{t+1} ⊙ S_t),
      dk_t = G_{t+1} v_t + u ⊙ r_t (v_t·dout_t),
      G_t = diag(w_t) G_{t+1} + r_t dout_tᵀ;
    * column sweep (the same G, by columns): dv_t = G_{t+1}ᵀ k_t +
      (Σ_i r_t u k_t) dout_t; ds0 = G_0.

    dw comes from the state itself, not from suffix sums of
    rowsum(S ⊙ G) increments, whose f32 errors, divided by w, miss the
    limit (tests/test_torch_wkv_bwd.py).  Returns what
    :func:`wkv_bhsd_bwd` returns.
    """
    check_wkv_shapes(r, k, v, w, u, s0)
    rf, kf, vf, wf, df = (t.float() for t in (r, k, v, w, dout))
    uf = u.float()
    n = r.shape[2]
    vdo = (vf * df).sum(-1, keepdim=True)         # [B, H, S, 1]
    ruk = (rf * uf[:, None] * kf).sum(-1, keepdim=True)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(s0[..., 0])

    def step(state, t):                           # S_{t+1} from S_t
        return wf[:, :, t, :, None] * state + kf[:, :, t, :, None] * vf[:, :, t, None, :]

    state, ckpts = s0.float(), []
    for t in range(n):
        if t % BWD_CHUNK == 0:
            ckpts.append(state)
        dr[:, :, t] = (state @ df[:, :, t, :, None])[..., 0] + uf * kf[:, :, t] * vdo[:, :, t]
        du = du + rf[:, :, t] * kf[:, :, t] * vdo[:, :, t]
        state = step(state, t)
    g = torch.zeros_like(state) if dsT is None else dsT.float()
    for c in reversed(range(len(ckpts))):
        steps = range(c * BWD_CHUNK, min((c + 1) * BWD_CHUNK, n))
        hist, state = [], ckpts[c]
        for t in steps:
            hist.append(state)
            state = step(state, t)
        for t, st in zip(reversed(steps), reversed(hist)):
            dw[:, :, t] = (g * st).sum(-1)
            dk[:, :, t] = (g @ vf[:, :, t, :, None])[..., 0] + uf * rf[:, :, t] * vdo[:, :, t]
            dv[:, :, t] = (kf[:, :, t, None, :] @ g)[..., 0, :] + ruk[:, :, t] * df[:, :, t]
            g = wf[:, :, t, :, None] * g + rf[:, :, t, :, None] * df[:, :, t, None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), g)


def _chunk_decays(wc):
    """(P, E, P_end) of chunks wc [..., C, hd]: P_t = prod_{s<t} w_s,
    E_b = prod_{b<s<C} w_s, both exclusive, and the whole chunk's product;
    products of w only."""
    ones = torch.ones_like(wc[..., :1, :])
    inclusive = torch.cumprod(wc, dim=-2)
    suffix = torch.flip(torch.cumprod(torch.flip(wc, [-2]), dim=-2), [-2])
    return (torch.cat([ones, inclusive[..., :-1, :]], dim=-2),
            torch.cat([suffix[..., 1:, :], ones], dim=-2), inclusive[..., -1, :])


def wkv_bhsd_bwd_chunked_plain(r, k, v, w, u, s0, dout, dsT=None):
    """The chunk-parallel backward kernel's arithmetic in torch (f32), for
    the CPU tests.  S is cut into chunks of C = :data:`BWD_CHUNK` steps (the
    last padded with r = k = v = dout = 0 and w = 1, which change nothing);
    inside chunk c, P_t and E_b are the exclusive products of w from its
    start and to its end, P_end the whole chunk's:

    1. the state chain, forward: S_0 = s0, S_{c+1} = diag(P_end) S_c +
       Σ_b (k_b ⊙ E_b) v_bᵀ;
    2. the gradient chain, backward: Ĝ_last = dsT (or 0), Ĝ_{c-1} =
       diag(P_end) Ĝ_c + Σ_t (r_t ⊙ P_t) dout_tᵀ, Ĝ_c being dL/dS after
       chunk c; its last value is ds0;
    3. every chunk at once: S_t forward from S_c and G_{t+1} backward from
       Ĝ_c, then dr_t = S_t·dout_t + u ⊙ k_t (v_t·dout_t), dk_t =
       G_{t+1} v_t + u ⊙ r_t (v_t·dout_t), dv_t = G_{t+1}ᵀ k_t +
       (Σ_i r_t u k_t) dout_t, dw_t = rowsum(G_{t+1} ⊙ S_t) and a du
       partial per chunk, summed over batch and chunks.

    The kernel runs 1 and 2 on the tensor cores with a*F in three bf16
    parts (tests/test_torch_wkv_bwd_chunked.py rehearses that arithmetic)
    and 3 in f32 on the CUDA cores.  Returns what :func:`wkv_bhsd_bwd`
    returns.
    """
    check_wkv_shapes(r, k, v, w, u, s0)
    b, h, s, hd = r.shape
    c = BWD_CHUNK
    n = -(-s // c)
    pad = (0, 0, 0, n * c - s)
    chunks = lambda t, value=0.0: F.pad(t.float(), pad, value=value).view(b, h, n, c, hd)  # noqa: E731
    rc, kc, vc, dc = (chunks(t) for t in (r, k, v, dout))
    wc = chunks(w, 1.0)
    uf = u.float()[None, :, None, None, :]           # [1, H, 1, 1, hd]
    p_excl, e_excl, p_end = _chunk_decays(wc)
    ke, rp = kc * e_excl, rc * p_excl
    state, states = s0.float(), []
    for i in range(n):                               # 1: S before chunk i
        states.append(state)
        state = p_end[:, :, i, :, None] * state + ke[:, :, i].transpose(-1, -2) @ vc[:, :, i]
    g = torch.zeros_like(s0, dtype=torch.float32) if dsT is None else dsT.float()
    grads = [None] * n
    for i in reversed(range(n)):                     # 2: G after chunk i
        grads[i] = g
        g = p_end[:, :, i, :, None] * g + rp[:, :, i].transpose(-1, -2) @ dc[:, :, i]
    vdo = (vc * dc).sum(-1, keepdim=True)            # [B, H, n, C, 1]
    ruk = (rc * uf * kc).sum(-1, keepdim=True)
    hist, st = [], torch.stack(states, dim=2)        # 3: [B, H, n, hd, hd]
    for t in range(c):
        hist.append(st)
        st = wc[..., t, :, None] * st + kc[..., t, :, None] * vc[..., t, None, :]
    gt = torch.stack(grads, dim=2)
    dr, dk, dv, dw = (torch.empty_like(rc) for _ in range(4))
    for t in reversed(range(c)):
        dr[..., t, :] = (hist[t] @ dc[..., t, :, None])[..., 0] + uf[..., 0, :] * kc[..., t, :] * vdo[..., t, :]
        dk[..., t, :] = (gt @ vc[..., t, :, None])[..., 0] + uf[..., 0, :] * rc[..., t, :] * vdo[..., t, :]
        dv[..., t, :] = (kc[..., t, None, :] @ gt)[..., 0, :] + ruk[..., t, :] * dc[..., t, :]
        dw[..., t, :] = (gt * hist[t]).sum(-1)
        gt = wc[..., t, :, None] * gt + rc[..., t, :, None] * dc[..., t, None, :]
    du = (rc * kc * vdo).sum(3)                      # [B, H, n, hd] partials
    unchunk = lambda t, dt: t.reshape(b, h, n * c, hd)[:, :, :s].to(dt)  # noqa: E731
    return (unchunk(dr, r.dtype), unchunk(dk, r.dtype), unchunk(dv, r.dtype),
            unchunk(dw, w.dtype), du.sum((0, 2)).to(u.dtype), g)


class _WKV(torch.autograd.Function):
    """The forward kernel with only its inputs saved, and the backward
    kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, sT = _forward(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)       # a dropped sT passes no dsT
        return out, sT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        grads = wkv_bhsd_bwd(r, k, v, w, u, s0, dout, dsT)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def wkv_bhsd(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV over r/k/v/w ``[B,H,S,hd]`` from the state s0; returns (out, sT).

    CPU tensors take the plain version, which autograd differentiates.
    Meta tensors return empty outputs and record the work.  CUDA tensors
    launch a kernel, which takes r/k/v of one dtype and w,
    each f32 or bf16 (w is read in its own dtype, never rounded to r's),
    all four in one layout with a unit stride over hd (16-byte-aligned
    bases and strides for the chunked kernel, whose cp.async loads need
    them); u f32 or bf16 (upcast here, which is exact); a contiguous f32
    s0; hd in :data:`KERNEL_HEAD_DIMS` and S >= 1.  Anything else raises.
    Under grad mode with an input that requires grad, the result carries
    the backward kernel as its ``grad_fn``.
    """
    check_wkv_shapes(r, k, v, w, u, s0)
    if {t.device for t in (r, k, v, w, u, s0)} == {torch.device("cpu")}:
        return wkv_bhsd_plain(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        return _WKV.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0)


def reset_launch_counts() -> None:
    """Zero the launch counts (the sum and each kernel's own) and the
    count of dout copies the backward made."""
    wkv_bhsd.launches = 0
    wkv_bhsd.variant_launches = dict.fromkeys(VARIANTS, 0)
    wkv_bhsd.dout_copies = 0


# kernel launches, all and by kernel; chip_smoke resets and reads them
reset_launch_counts()
