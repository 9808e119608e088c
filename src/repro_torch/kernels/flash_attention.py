"""Flash attention — wrapper of the Hopper kernels in
``csrc/flash_attention.cu``, the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``.

:func:`flash_attention_bhsd` keeps the TPU kernel's contract: q
``[BHq, S, hd]``, k/v ``[BHkv, S, hd]``, causal or full, scaled by
``hd**-0.5``, query head ``b`` reading kv head ``b // (BHq // BHkv)``,
output in ``q.dtype``.  On CPU tensors it runs
:func:`flash_attention_bhsd_plain`; on CUDA tensors it launches one of
two kernels or raises — there is no fallback, neither to the plain
version nor from one kernel to the other:

* ``"wgmma"``: bf16 at hd in :data:`WGMMA_HEAD_DIMS`, on the tensor
  cores with TMA loads (p split into two bf16 halves, so the numerics
  stay the TPU kernel's f32 softmax);
* ``"cuda_core"``: every other call it takes (f32, and bf16 at hd 16 and
  32), f32 arithmetic on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_attention_shapes, reference_attention

__all__ = ["flash_attention_bhsd", "flash_attention_bhsd_plain",
           "kernel_variant", "reset_launch_counts", "KERNEL_HEAD_DIMS",
           "VARIANTS", "WGMMA_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
VARIANTS = ("wgmma", "cuda_core")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {"wgmma": "repro_flash_attention_fwd_wgmma",
          "cuda_core": "repro_flash_attention_fwd"}
# the plain version is the oracle itself: one plain attention in the port
flash_attention_bhsd_plain = reference_attention


def kernel_variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves a CUDA call of this dtype and head dim."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "cuda_core"


@functools.lru_cache(maxsize=None)
def _kernel(variant: str):
    fn = getattr(load_library("flash_attention"), _ENTRY[variant])
    # pointers and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention over a flattened (batch, head) leading dim.

    CPU tensors take the plain version; CUDA tensors launch a kernel,
    which takes contiguous f32 or bf16 tensors with hd in
    :data:`KERNEL_HEAD_DIMS` (16-byte-aligned ones for the tensor-core
    kernel, whose TMA loads need it); anything else raises.
    """
    check_attention_shapes(q, k, v)
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        return flash_attention_bhsd_plain(q, k, v, causal=causal)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v must all be on one CUDA device or all on "
                         f"the CPU; got {sorted(map(str, devices))}")
    bh, s, hd = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, not {hd}")
    if s == 0 or -(-s // 64) > 65535:
        raise ValueError(f"kernel takes 1 <= S <= {65535 * 64}, not {s}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    variant = kernel_variant(q.dtype, hd)
    if variant == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel takes q, k, v at 16-byte-aligned "
                         "addresses (TMA); got a view that starts off that alignment")
    o = torch.empty_like(q)
    fn = _kernel(variant)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 bh, k.shape[0], s, hd, int(q.dtype == torch.bfloat16),
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash attention {variant} kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_bhsd.variant_launches[variant] += 1
    flash_attention_bhsd.launches += 1
    return o


def reset_launch_counts() -> None:
    """Zero the launch counts: the sum and each kernel's own."""
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.variant_launches = dict.fromkeys(VARIANTS, 0)


# kernel launches, all and by kernel; chip_smoke resets and reads them
reset_launch_counts()
