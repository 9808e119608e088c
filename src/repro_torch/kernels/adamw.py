"""AdamW on the card — wrapper of the two passes in ``csrc/adamw.cu``.

No TPU kernel is replaced: JAX's AdamW is plain jnp that XLA fuses under
``jit``.  The port's eager AdamW (:func:`repro_torch.optim.adamw_update_eager`,
on CPU and meta leaves) moves about 200 bytes of device memory a
parameter in some twenty kernels a leaf; these two passes move 30-32:

* :func:`grad_sumsq`: every grad leaf's sum of squares and their sum,
  in one launch over a device table of the leaves (and a one-block
  finish), in a fixed order: the same grads give the same bits.
* :func:`update`: one leaf's clip multiply and AdamW update in one
  pass, in place, bit-equal to the eager path for the same clip scale.

The eager path is the plain version of both, and the oracle the card
tests hold them to.  The library builds at the first call, never at
import; CPU tensors are refused (:func:`takes` says which leaves the
kernels take).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

__all__ = ["CHUNK", "grad_sumsq", "reset_launch_counts", "takes", "update"]

_ENTRY = {"sumsq": "repro_adamw_sumsq", "update": "repro_adamw_update"}
# elements of a leaf summed by one block into one partial
CHUNK = 1 << 16
_PARAM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MOMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN = (torch.Tensor, torch.nn.Parameter)     # no subclass: DTensor, fake, ...


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(load_library("adamw"), _ENTRY[name])
    # pointers and the stream as c_void_p, sizes as c_longlong: ctypes
    # would otherwise pass Python ints as 32-bit C ints and cut them
    if name == "sumsq":     # table, n_leaves, n_chunks, chunk, partials, sums
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    else:                   # g, m, v, master, p, n, dtypes, 4 scalars, 6 constants
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def takes(p, g, m, v, master) -> bool:
    """Whether the kernels update this leaf: plain contiguous tensors of
    one shape on one CUDA device, the param in f32, bf16 or f16 with its
    grad in the same type, moments in f32 or bf16, an f32 master."""
    ts = (p, g, m, v, master)
    return (all(type(t) in _PLAIN and t.device == p.device and t.is_contiguous()
                and t.shape == p.shape for t in ts)
            and p.device.type == "cuda" and p.dtype in _PARAM_CODES and g.dtype == p.dtype
            and m.dtype in _MOMENT_CODES and v.dtype == m.dtype
            and master.dtype == torch.float32)


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"adamw {name} kernel launch failed: cudaError_t {err}")
    update.launches[name] += 1


def grad_sumsq(grads) -> torch.Tensor:
    """f32 ``[len(grads) + 1]`` on the grads' device: each leaf's sum of
    squares (in f32, from its own type), then the leaves' sums added in
    order from 0, as the eager global norm adds them.  ``grads``: plain
    contiguous CUDA tensors of one device in f32, bf16 or f16."""
    grads = list(grads)
    device = grads[0].device
    rows, first = [], 0
    for g in grads:
        if (type(g) not in _PLAIN or g.device != device or device.type != "cuda"
                or not g.is_contiguous() or g.dtype not in _PARAM_CODES):
            raise ValueError(f"the sum-of-squares kernel takes contiguous f32, bf16 or f16 "
                             f"tensors on one CUDA device, not {type(g).__name__} "
                             f"{g.dtype} on {g.device}")
        rows.append((g.data_ptr(), g.numel(), first, _PARAM_CODES[g.dtype]))
        first += -(-g.numel() // CHUNK)
    # a pinned copy: the caching host allocator holds it until the copy ran
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(device, non_blocking=True)
    partials = torch.empty(first, dtype=torch.float32, device=device)
    sums = torch.empty(len(grads) + 1, dtype=torch.float32, device=device)
    _launch("sumsq", device, table.data_ptr(), len(grads), first, CHUNK,
            partials.data_ptr(), sums.data_ptr())
    return sums


def update(p, g, m, v, master, scale, bc1, bc2, lr, *, b1: float, b2: float, eps: float,
           weight_decay: float) -> None:
    """One leaf's AdamW step in place (raises unless :func:`takes`): ``g``
    clipped by ``scale`` cast to its type, ``m``, ``v`` and ``master``
    updated, ``p`` set to ``master`` in its type.  ``scale``, ``bc1``,
    ``bc2`` and ``lr`` are f32 0-d tensors on the leaf's device, read
    there by the kernel."""
    if not takes(p, g, m, v, master):
        raise ValueError("the AdamW update kernel takes plain contiguous CUDA leaves of one "
                         "shape: an f32, bf16 or f16 param and grad, f32 or bf16 moments and "
                         "an f32 master")
    scalars = (scale, bc1, bc2, lr)
    if any(s.dtype != torch.float32 or s.numel() != 1 or s.device != p.device for s in scalars):
        raise ValueError("scale, bc1, bc2 and lr must be f32 scalars on the leaf's device")
    # each constant as ATen takes a Python scalar: the double rounded to f32
    _launch("update", p.device, g.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
            p.data_ptr(), p.numel(), _PARAM_CODES[p.dtype], _MOMENT_CODES[m.dtype],
            *(s.data_ptr() for s in scalars), b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay)


def reset_launch_counts() -> None:
    """Zero the launch counts of both kernels (``update.launches``)."""
    update.launches = dict.fromkeys(_ENTRY, 0)


reset_launch_counts()
