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
and saves only the inputs, and its gradient is the ``"backward"`` kernel
(:func:`wkv_bhsd_bwd`), which recomputes the state from checkpoints it
writes itself.  The TPU kernel has no backward; JAX differentiates its
jnp model path.  :func:`wkv_bhsd_bwd_plain` rehearses the backward
kernel's arithmetic in torch for the CPU tests; the plain gradient the
card is held against is autograd of :func:`wkv_bhsd_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_wkv_shapes, reference_wkv

__all__ = ["wkv_bhsd", "wkv_bhsd_bwd", "wkv_bhsd_bwd_plain", "wkv_bhsd_plain",
           "kernel_variant", "launch", "reset_launch_counts", "BWD_CHUNK",
           "CHUNKED_HEAD_DIM", "CHUNKED_MIN_SEQ", "KERNEL_HEAD_DIMS", "VARIANTS"]

KERNEL_HEAD_DIMS = (8, 16, 32, 64)
CHUNKED_HEAD_DIM = 64
# Shortest S that the chunked kernel serves; below it the sequential
# kernel is as fast or faster (chip_smoke.py's wkv_choice rows, PERF.md).
CHUNKED_MIN_SEQ = 16
# Steps between the backward kernel's state checkpoints (kBwdChunk in
# csrc/rwkv_wkv.cu): each row block recomputes a chunk's states from one.
BWD_CHUNK = 16
# the two forward kernels and the backward one, each counted on its own
VARIANTS = ("chunked", "sequential", "backward")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {"chunked": "repro_wkv_fwd_chunked", "sequential": "repro_wkv_fwd",
          "backward": "repro_wkv_bwd"}
# the plain version is the oracle itself: one plain WKV in the port
wkv_bhsd_plain = reference_wkv


def kernel_variant(dtype: torch.dtype, w_dtype: torch.dtype, hd: int, s: int) -> str:
    """The kernel that serves a CUDA call of r/k/v ``dtype``, w ``w_dtype``,
    head dim ``hd`` and length ``s``."""
    chunked = (dtype == torch.bfloat16 and w_dtype in _KERNEL_DTYPES
               and hd == CHUNKED_HEAD_DIM and s >= CHUNKED_MIN_SEQ)
    return "chunked" if chunked else "sequential"


@functools.lru_cache(maxsize=None)
def _kernel(variant: str):
    fn = getattr(load_library("rwkv_wkv"), _ENTRY[variant])
    # pointers and the stream as c_void_p, strides as 64-bit: ctypes would
    # otherwise pass Python ints as 32-bit C ints and cut them.
    # Forward: 8 pointers, (batch, heads, seq, hd), two sets of strides,
    # then the flags (bf16_rkv, bf16_w) or, for the chunked kernel, bf16_w
    # alone.  Backward: 15 pointers, (batch, heads, seq, hd), three sets of
    # strides (inputs, dout, gradients), (bf16_rkv, bf16_w).
    n_ptr, n_strides = (15, 9) if variant == "backward" else (8, 6)
    flags = 1 if variant == "chunked" else 2
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

    :func:`wkv_bhsd` checks and counts; ``chip_smoke.py`` calls this to
    time a kernel on inputs the wrapper would give the other one."""
    b, h, s, hd = r.shape
    out = torch.empty_like(r)
    sT = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
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


def _check_cuda(r, k, v, w, u, s0) -> str:
    """Raise unless the kernels take these CUDA tensors; the forward variant."""
    devices = {t.device for t in (r, k, v, w, u, s0)}
    if len(devices) != 1 or r.device.type != "cuda":
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
    if variant == "chunked" and any(
            t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in _strides(t))
            for t in (r, k, v, w)):
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
    _count(variant)
    return out, sT


def wkv_bhsd_bwd(r, k, v, w, u, s0, dout, dsT=None):
    """(dr, dk, dv, dw, du, ds0) of :func:`wkv_bhsd` at its inputs for the
    output gradient ``dout`` and the final state's ``dsT`` (f32, None for
    zero): one launch of the backward kernel.

    It takes what the forward kernels take, and ``dout`` of r's shape and
    dtype in any layout: a view without a unit stride over hd is copied
    first (counted in ``wkv_bhsd.dout_copies``).  dr, dk and dv come in r's
    dtype and dw in w's, all four in r's layout where r is dense (as the
    forward allocates out); du in u's dtype; ds0 f32."""
    _check_cuda(r, k, v, w, u, s0)
    b, h, s, hd = r.shape
    if dout.shape != r.shape or dout.dtype != r.dtype or dout.device != r.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match r "
                         f"{tuple(r.shape)} {r.dtype}")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
        wkv_bhsd.dout_copies += 1
    if dsT is not None:
        if dsT.shape != s0.shape or dsT.device != r.device:
            raise ValueError(f"dsT {tuple(dsT.shape)} does not match s0 {tuple(s0.shape)}")
        dsT = dsT.float().contiguous()
    dr = torch.empty_like(r)
    dk, dv = (torch.empty_strided(r.shape, dr.stride(), dtype=r.dtype, device=r.device)
              for _ in range(2))
    dw = torch.empty_strided(r.shape, dr.stride(), dtype=w.dtype, device=r.device)
    du = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)   # per batch row
    ds0 = torch.empty_like(s0)
    n_ckpt = (s - 1) // BWD_CHUNK          # states after steps C, 2C, ... before S
    ckpt = torch.empty((max(b * h * n_ckpt * hd * hd, 1),), dtype=torch.float32,
                       device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel("backward")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.float().contiguous().data_ptr(), s0.data_ptr(), dout.data_ptr(),
            None if dsT is None else dsT.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(), ckpt.data_ptr(),
            b, h, s, hd, *_strides(r), *_strides(dout), *_strides(dr),
            int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"WKV backward kernel launch failed: cudaError_t {err}")
    _count("backward")
    return dr, dk, dv, dw, du.sum(0).to(u.dtype), ds0


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
    CUDA tensors launch a kernel, which takes r/k/v of one dtype and w,
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
