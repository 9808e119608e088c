"""Flash attention — wrapper of the Hopper kernels in
``csrc/flash_attention.cu``, the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``, and of its
gradient.

:func:`flash_attention_bhsd` keeps the TPU kernel's contract: q
``[BHq, S, hd]``, k/v ``[BHkv, S, hd]``, causal or full, scaled by
``hd**-0.5``, query head ``b`` reading kv head ``b // (BHq // BHkv)``,
output in ``q.dtype``.  It adds the JAX model's sliding window, which the
TPU kernel lacks: ``sliding_window=W > 0`` keeps key ``k`` for query ``q``
only if ``k > q - W`` (with or without the causal mask; 0 is no window,
and a window of at least S masks nothing and gives the bits of none).
Every kernel below takes it and skips the tiles it empties.  On CPU
tensors it runs
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

Meta tensors (the dry run, :mod:`repro_torch.launch.dryrun`) take the
CUDA path's checks and allocations, and in place of each launch the
kernel's work goes to :func:`cost.record` (the operations and bytes of
``kernels/cost.py``); no kernel runs and no launch is counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cost
from ._build import load_library
from .ref import check_attention_shapes, reference_attention

__all__ = ["flash_attention_bhsd", "flash_attention_bhsd_plain",
           "flash_attention_bwd", "backward_variant", "kernel_variant", "mask_name",
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
    # Ints: bh, bh_kv, seq, hd, is_bf16, causal, window.
    n_ptr = 9 if variant.startswith("backward") else 5
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on_meta(*ts) -> bool:
    return all(t.device.type == "meta" for t in ts)


def _check_cuda(q, k, v, sliding_window: int = 0) -> str:
    """Raise unless the kernels take these CUDA (or meta) tensors and this
    window; the forward variant."""
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0 (0: none), not {sliding_window}")
    devices = {t.device for t in (q, k, v)}
    meta = _on_meta(q, k, v)
    if not meta and (len(devices) != 1 or q.device.type != "cuda"):
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
    if variant == "wgmma" and not meta and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel takes q, k, v at 16-byte-aligned "
                         "addresses (TMA); got a view that starts off that alignment")
    return variant


def _record(name: str, variant: str, flops: int, nbytes: int) -> None:
    """A launch on meta tensors: no kernel runs and no count moves; the
    work goes to the dry run's analysis (:func:`cost.record`), at the
    tensor cores' rate for the tensor-core kernels, else at f32's."""
    cost.record(name, flops, nbytes, "bf16" if variant in ("wgmma", "backward_wgmma") else "f32")


def mask_name(causal: bool, sliding_window: int, s: int) -> str:
    """The mask of a call as ``mask_launches`` names it: "causal" or
    "full", with "+window" where the window masks a key (W < S)."""
    return ("causal" if causal else "full") + ("+window" if 0 < sliding_window < s else "")


def _launch(variant: str, device, mask: str, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(variant)(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash attention {variant} kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention_bhsd.variant_launches[variant] += 1
    flash_attention_bhsd.launches += 1
    counts = flash_attention_bhsd.mask_launches
    key = f"{variant}/{mask}"
    counts[key] = counts.get(key, 0) + 1


def _forward(q, k, v, causal: bool, with_lse: bool, sliding_window: int = 0):
    """(o, lse or None) from one forward launch on checked CUDA tensors."""
    variant = _check_cuda(q, k, v, sliding_window)
    bh, s, hd = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if _on_meta(q):
        _record(f"flash_attention_bhsd[{variant}]", variant, cost.attention_flops(
            bh, s, hd, causal, sliding_window),
            cost.attention_bytes(bh, k.shape[0], s, hd, q.element_size()))
        return o, lse
    _launch(variant, q.device, mask_name(causal, sliding_window, s), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            bh, k.shape[0], s, hd, int(q.dtype == torch.bfloat16), int(causal),
            min(sliding_window, s), hd ** -0.5)
    return o, lse


def flash_attention_bwd(q, k, v, lse, do, *, causal: bool = True, sliding_window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_bhsd` at q, k, v for the
    output gradient ``do``, from the forward's ``lse`` (f32 ``[BHq, S]``,
    from a forward with the same mask and window).

    One launch of the backward kernel that :func:`backward_variant` picks;
    it takes what the forward kernels take (``do`` in q's dtype and shape,
    at a 16-byte-aligned address for the tensor-core one) and raises on
    anything else."""
    _check_cuda(q, k, v, sliding_window)
    bh, s, hd = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if (lse.shape != (bh, s) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 [{bh}, {s}] tensor on q's device")
    do = do.contiguous()
    variant = backward_variant(q.dtype, hd)
    meta = _on_meta(q, do)
    if variant == "backward_wgmma":
        if not meta and do.data_ptr() % 16:
            raise ValueError("the tensor-core backward takes dO at a 16-byte-aligned "
                             "address (TMA); got a view that starts off that alignment")
        # each row's {lse in log2 units, D}, written by its first kernel
        scratch = torch.empty((bh, -(-s // _BWD_WGMMA_ROWS) * _BWD_WGMMA_ROWS, 2),
                              dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty_like(lse)    # D
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if meta:
        _record(f"flash_attention_bwd[{variant}]", variant,
                cost.bwd_flops(bh, s, hd, causal, sliding_window),
                cost.bwd_bytes(bh, k.shape[0], s, hd, q.element_size()))
        return dq, dk, dv
    _launch(variant, q.device, mask_name(causal, sliding_window, s), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, k.shape[0], s, hd,
            int(q.dtype == torch.bfloat16), int(causal), min(sliding_window, s), hd ** -0.5)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its lse saved, and a backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        o, lse = _forward(q, k, v, causal, with_lse=True, sliding_window=sliding_window)
        # the backward sums D from p * dP itself, so it needs no o
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        ctx.sliding_window = sliding_window
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, lse, do, causal=ctx.causal,
                                     sliding_window=ctx.sliding_window), None, None)


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0) -> torch.Tensor:
    """Flash attention over a flattened (batch, head) leading dim, with an
    optional sliding window (``sliding_window`` > 0: key k kept for query q
    only if k > q - W).

    CPU tensors take the plain version.  Meta tensors return empty outputs
    and record the work.  CUDA tensors launch a kernel,
    which takes contiguous f32 or bf16 tensors with hd in
    :data:`KERNEL_HEAD_DIMS` (16-byte-aligned ones for the tensor-core
    kernel, whose TMA loads need it) and a window >= 0; anything else
    raises.  Under grad mode with an input that requires grad, the result
    carries a backward kernel as its ``grad_fn``.
    """
    check_attention_shapes(q, k, v)
    if {t.device for t in (q, k, v)} == {torch.device("cpu")}:
        return flash_attention_bhsd_plain(q, k, v, causal=causal, sliding_window=sliding_window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sliding_window)
    return _forward(q, k, v, causal, with_lse=False, sliding_window=sliding_window)[0]


def reset_launch_counts() -> None:
    """Zero the launch counts: the sum, each kernel's own, and each
    kernel's by mask (``"wgmma/causal"``, ``"wgmma/full"``,
    ``"wgmma/causal+window"``, ...: :func:`mask_name`; a key appears with
    its first launch)."""
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.variant_launches = dict.fromkeys(VARIANTS, 0)
    flash_attention_bhsd.mask_launches = {}


# kernel launches, all, by kernel and by kernel and mask; chip_smoke
# resets and reads them
reset_launch_counts()
