"""Flash attention — wrapper of the Hopper kernel in
``csrc/flash_attention.cu``, the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``.

:func:`flash_attention_bhsd` keeps the TPU kernel's contract: q
``[BHq, S, hd]``, k/v ``[BHkv, S, hd]``, causal or full, scaled by
``hd**-0.5``, query head ``b`` reading kv head ``b // (BHq // BHkv)``,
output in ``q.dtype``.  On CPU tensors it runs
:func:`flash_attention_bhsd_plain`; on CUDA tensors it launches the
kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_attention_shapes, reference_attention

__all__ = ["flash_attention_bhsd", "flash_attention_bhsd_plain",
           "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the plain version is the oracle itself: one plain attention in the port
flash_attention_bhsd_plain = reference_attention


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("flash_attention")
    fn = lib.repro_flash_attention_fwd
    # pointers and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention over a flattened (batch, head) leading dim.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous f32 or bf16 tensors with hd in
    :data:`KERNEL_HEAD_DIMS`; anything else raises.
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
    o = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 bh, k.shape[0], s, hd, int(q.dtype == torch.bfloat16),
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {err}")
    flash_attention_bhsd.launches += 1
    return o


flash_attention_bhsd.launches = 0   # kernel launches; chip_smoke resets and reads it
