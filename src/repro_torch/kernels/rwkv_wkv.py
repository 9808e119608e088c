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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_wkv_shapes, reference_wkv

__all__ = ["wkv_bhsd", "wkv_bhsd_plain", "kernel_variant", "launch", "reset_launch_counts",
           "CHUNKED_HEAD_DIM", "CHUNKED_MIN_SEQ", "KERNEL_HEAD_DIMS", "VARIANTS"]

KERNEL_HEAD_DIMS = (8, 16, 32, 64)
CHUNKED_HEAD_DIM = 64
# Shortest S that the chunked kernel serves; below it the sequential
# kernel is as fast or faster (chip_smoke.py's wkv_choice rows, PERF.md).
CHUNKED_MIN_SEQ = 16
VARIANTS = ("chunked", "sequential")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {"chunked": "repro_wkv_fwd_chunked", "sequential": "repro_wkv_fwd"}
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
    # otherwise pass Python ints as 32-bit C ints and cut them
    # (batch, heads, seq, hd), two sets of strides, then the flags:
    # (bf16_rkv, bf16_w) or, for the chunked kernel, bf16_w alone
    flags = 1 if variant == "chunked" else 2
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * flags + [ctypes.c_void_p])
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


def wkv_bhsd(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV over r/k/v/w ``[B,H,S,hd]`` from the state s0; returns (out, sT).

    CPU tensors take the plain version.  CUDA tensors launch a kernel,
    which takes r/k/v of one dtype and w, each f32 or bf16 (w is read in
    its own dtype, never rounded to r's), all four in one layout with a
    unit stride over hd (16-byte-aligned bases and strides for the
    chunked kernel, whose cp.async loads need them); u f32 or bf16
    (upcast here, which is exact); a contiguous f32 s0; hd in
    :data:`KERNEL_HEAD_DIMS` and S >= 1.  Anything else raises.
    """
    check_wkv_shapes(r, k, v, w, u, s0)
    devices = {t.device for t in (r, k, v, w, u, s0)}
    if devices == {torch.device("cpu")}:
        return wkv_bhsd_plain(r, k, v, w, u, s0)
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
    out, sT = launch(variant, r, k, v, w, u.float().contiguous(), s0)
    wkv_bhsd.variant_launches[variant] += 1
    wkv_bhsd.launches += 1
    return out, sT


def reset_launch_counts() -> None:
    """Zero the launch counts: the sum and each kernel's own."""
    wkv_bhsd.launches = 0
    wkv_bhsd.variant_launches = dict.fromkeys(VARIANTS, 0)


# kernel launches, all and by kernel; chip_smoke resets and reads them
reset_launch_counts()
