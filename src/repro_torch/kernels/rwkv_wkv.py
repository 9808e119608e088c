"""RWKV6 WKV recurrence — wrapper of the Hopper kernel in
``csrc/rwkv_wkv.cu``, the port of the Pallas TPU kernel
``repro/kernels/rwkv_wkv.py::wkv_bhsd``.

:func:`wkv_bhsd` keeps the TPU kernel's contract — r/k/v/w
``[B,H,S,hd]``, u ``[H,hd]``, s0 ``[B,H,hd,hd]``; returns (out in r's
dtype, the final state in f32) — without its ``S % chunk == 0``
restriction and ``chunk`` argument, which were artefacts of the TPU's
tiling: any S >= 1 runs, and S = 1 is one decode step.  On CPU tensors
it runs :func:`wkv_bhsd_plain`; on CUDA tensors it launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_wkv_shapes, reference_wkv

__all__ = ["wkv_bhsd", "wkv_bhsd_plain", "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (8, 16, 32, 64)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the plain version is the oracle itself: one plain WKV in the port
wkv_bhsd_plain = reference_wkv


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("rwkv_wkv")
    fn = lib.repro_wkv_fwd
    # pointers and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv_bhsd(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV over r/k/v/w ``[B,H,S,hd]`` from the state s0; returns (out, sT).

    CPU tensors take the plain version.  CUDA tensors launch the kernel,
    which takes contiguous r/k/v of one dtype and w, each f32 or bf16 (w
    is read in its own dtype, never rounded to r's), u f32 or bf16
    (upcast here, which is exact), an f32 s0, hd in
    :data:`KERNEL_HEAD_DIMS` and S >= 1; anything else raises.
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
    if not all(t.is_contiguous() for t in (r, k, v, w, s0)):
        raise ValueError("kernel takes contiguous r, k, v, w, s0")
    u = u.float().contiguous()
    out = torch.empty_like(r)
    sT = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(), sT.data_ptr(),
                 b * h, h, s, hd, int(r.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"WKV kernel launch failed: cudaError_t {err}")
    wkv_bhsd.launches += 1
    return out, sT


wkv_bhsd.launches = 0   # kernel launches; chip_smoke resets and reads it
