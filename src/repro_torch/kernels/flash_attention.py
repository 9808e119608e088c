"""Flash attention — wrapper of the Hopper kernels in
``csrc/flash_attention.cu``, the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``, and of its
gradient.

:func:`flash_attention_bhsd` keeps the TPU kernel's contract: q
``[BHq, S, hd]``, k/v ``[BHkv, S, hd]``, causal or full, scaled by
``hd**-0.5``, query head ``b`` reading kv head ``b // (BHq // BHkv)``,
output in ``q.dtype``.  On CPU tensors it runs
:func:`flash_attention_bhsd_plain`, which autograd differentiates; on
CUDA tensors it launches one of two forward kernels or raises — there is
no fallback, neither to the plain version nor from one kernel to the
other:

* ``"wgmma"``: bf16 at hd in :data:`WGMMA_HEAD_DIMS`, on the tensor
  cores with TMA loads (p split into two bf16 halves, so the numerics
  stay the TPU kernel's f32 softmax);
* ``"cuda_core"``: every other call it takes (f32, and bf16 at hd 16 and
  32), f32 arithmetic on the CUDA cores.

When grad mode is on and q, k or v requires grad, the CUDA call is a
:class:`torch.autograd.Function`: the forward kernel also writes each
row's log-sum-exp, and the gradient is one of two backward kernels,
picked by :func:`backward_variant`, so attention's gradient on the card
never silently vanishes:

* ``"backward_wgmma"``: the calls whose forward is ``"wgmma"``, on the
  tensor cores with TMA loads (p and dS split into two bf16 halves, D
  summed from p * dP in f32);
* ``"backward"``: the rest (f32, and bf16 at hd 16 and 32), f32
  arithmetic on the CUDA cores.

The TPU kernel has no backward; JAX differentiates its jnp model path
instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .ref import check_attention_shapes, reference_attention

__all__ = ["flash_attention_bhsd", "flash_attention_bhsd_plain",
           "flash_attention_bwd", "backward_variant", "kernel_variant",
           "reset_launch_counts", "KERNEL_HEAD_DIMS", "VARIANTS", "WGMMA_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
# the two forward kernels and the two backward ones, each counted on its own
VARIANTS = ("wgmma", "cuda_core", "backward", "backward_wgmma")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {"wgmma": "repro_flash_attention_fwd_wgmma",
          "cuda_core": "repro_flash_attention_fwd",
          "backward": "repro_flash_attention_bwd",
          "backward_wgmma": "repro_flash_attention_bwd_wgmma"}
# rows of the tensor-core backward's scratch: its dQ kernel's 128-row tiles
_BWD_WGMMA_ROWS = 128
# the plain version is the oracle itself: one plain attention in the port
flash_attention_bhsd_plain = reference_attention


def kernel_variant(dtype: torch.dtype, hd: int) -> str:
    """The forward kernel that serves a CUDA call of this dtype and head dim."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "cuda_core"


def backward_variant(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel that serves a CUDA call of this dtype and head
    dim: the tensor-core one exactly where the forward is ``"wgmma"``."""
    return "backward_wgmma" if kernel_variant(dtype, hd) == "wgmma" else "backward"


@functools.lru_cache(maxsize=None)
def _kernel(variant: str):
    fn = getattr(load_library("flash_attention"), _ENTRY[variant])
    # pointers and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them.  Forward: q, k, v, o, lse;
    # backward: q, k, v, dO, lse, scratch, dq, dk, dv.
    n_ptr = 9 if variant.startswith("backward") else 5
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v) -> str:
    """Raise unless the kernels take these CUDA tensors; the forward variant."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v must all be on one CUDA device or all on "
                         f"the CPU; got {sorted(map(str, devices))}")
    _, s, hd = q.shape
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
    return variant


def _launch(variant: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(variant)(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash attention {variant} kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_bhsd.variant_launches[variant] += 1
    flash_attention_bhsd.launches += 1


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(o, lse or None) from one forward launch on checked CUDA tensors."""
    variant = _check_cuda(q, k, v)
    bh, s, hd = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch(variant, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, k.shape[0], s, hd,
            int(q.dtype == torch.bfloat16), int(causal), hd ** -0.5)
    return o, lse


def flash_attention_bwd(q, k, v, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_bhsd` at q, k, v for the
    output gradient ``do``, from the forward's ``lse`` (f32 ``[BHq, S]``).

    One launch of the backward kernel that :func:`backward_variant` picks;
    it takes what the forward kernels take (``do`` in q's dtype and shape,
    at a 16-byte-aligned address for the tensor-core one) and raises on
    anything else."""
    _check_cuda(q, k, v)
    bh, s, hd = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if (lse.shape != (bh, s) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 [{bh}, {s}] tensor on q's device")
    do = do.contiguous()
    variant = backward_variant(q.dtype, hd)
    if variant == "backward_wgmma":
        if do.data_ptr() % 16:
            raise ValueError("the tensor-core backward takes dO at a 16-byte-aligned "
                             "address (TMA); got a view that starts off that alignment")
        # each row's {lse in log2 units, D}, written by its first kernel
        scratch = torch.empty((bh, -(-s // _BWD_WGMMA_ROWS) * _BWD_WGMMA_ROWS, 2),
                              dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty_like(lse)    # D
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch(variant, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, k.shape[0], s, hd, int(q.dtype == torch.bfloat16), int(causal), hd ** -0.5)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its lse saved, and a backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, with_lse=True)
        # the backward sums D from p * dP itself, so it needs no o
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, lse, do, causal=ctx.causal), None)


def flash_attention_bhsd(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention over a flattened (batch, head) leading dim.

    CPU tensors take the plain version.  CUDA tensors launch a kernel,
    which takes contiguous f32 or bf16 tensors with hd in
    :data:`KERNEL_HEAD_DIMS` (16-byte-aligned ones for the tensor-core
    kernel, whose TMA loads need it); anything else raises.  Under grad
    mode with an input that requires grad, the result carries a backward
    kernel as its ``grad_fn``.
    """
    check_attention_shapes(q, k, v)
    if {t.device for t in (q, k, v)} == {torch.device("cpu")}:
        return flash_attention_bhsd_plain(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]


def reset_launch_counts() -> None:
    """Zero the launch counts: the sum and each kernel's own."""
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.variant_launches = dict.fromkeys(VARIANTS, 0)


# kernel launches, all and by kernel; chip_smoke resets and reads them
reset_launch_counts()
