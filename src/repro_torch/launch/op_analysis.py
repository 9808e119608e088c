"""Op-level analysis of one eager step — the port's counterpart of
``repro/launch/hlo_analysis.py``.

JAX reads the roofline inputs from the optimized per-device HLO.  The
port has no HLO: a step runs eagerly, so its counterpart is the stream of
aten ops the step dispatches, seen by one ``TorchDispatchMode`` while the
step runs (on meta tensors in a dry run, where nothing is computed):

* **FLOPs** — ``torch.utils.flop_counter``'s formulas for the ops of plain
  tensors (``2 x m x n x k`` a product, as JAX counts a ``dot``), plus the
  work each kernel records at a meta launch (:mod:`repro_torch.kernels.cost`),
  kept by the dtype of the peak rate they run at.
* **HBM bytes** — in eager mode every op is a trip to HBM (the counterpart
  of JAX's fusion boundaries), so each op costs the bytes of its operands
  and its results.  Views, ``detach`` and metadata-only ops cost nothing,
  as ``bitcast``, ``get-tuple-element`` and ``parameter`` do there; a
  gather or an indexed write counts only the slice it reads and writes.
* **Collectives** — every ``_c10d_functional`` op by type, its bytes its
  input's, with JAX's ring wire factors (all-reduce 2x, the others 1x).
* **Peak live bytes** — each op's output storages are followed with weak
  references from the moment they appear until they are freed; the peak
  counts the step's arguments (what ``memory_analysis()`` gives JAX).

DTensor.  A mode sees a DTensor op before DTensor's own dispatch, at the
DTensor's global shapes.  The mode passes such an op on
(``NotImplemented``): DTensor then runs its sharding propagation (on
FakeTensors, which the mode runs uncounted), its redistributions (the
functional collectives) and the op on the local shards with the mode
still active, so every count here is per rank.  The local regions of
``models/shards.py`` run on plain local tensors and are counted as they
run.

Loops need no weighting: an eager step dispatches every iteration.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

__all__ = ["OpStats", "CollectiveStats", "analyze", "argument_bytes"]

_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}

# the functional collectives DTensor issues, by name -> JAX's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

_aten = torch.ops.aten
# allocation or metadata only: no HBM traffic
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten.resize_.default, _aten._local_scalar_dense.default,
    _aten.detach.default, _aten.alias.default,
}
# reads only the rows it gathers: the result, read and written
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default, _aten.take.default}
# writes only a slice of its first operand: the update, read and written
_SLICE_WRITES = {_aten.index_put_.default, _aten.index_put.default,
                 _aten._index_put_impl_.default, _aten.index_copy_.default,
                 _aten.index_add_.default, _aten.scatter_.src, _aten.scatter.src,
                 _aten.scatter_add_.default, _aten.scatter_add.default,
                 _aten.slice_scatter.default, _aten.select_scatter.default}


def _dispatches_itself(t: torch.Tensor) -> bool:
    """A tensor subclass with a dispatch of its own (DTensor,
    AsyncCollectiveTensor, FakeTensor), not a plain tensor or Parameter."""
    return type(t).__torch_dispatch__ is not torch.Tensor.__torch_dispatch__


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op touches of ``t``: its elements, but no more than its
    storage holds (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _rate(dtype: torch.dtype) -> str:
    return "f32" if dtype in (torch.float32, torch.float64) else "bf16"


@dataclass
class CollectiveStats:
    bytes_by_type: dict = field(default_factory=dict)
    wire_bytes: float = 0.0
    count_by_type: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_type.values()))

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes_by_type[kind] = self.bytes_by_type.get(kind, 0.0) + nbytes
        self.count_by_type[kind] = self.count_by_type.get(kind, 0) + 1
        self.wire_bytes += nbytes * _WIRE_FACTOR[kind]


@dataclass
class OpStats:
    """Per-rank totals of one analysed call."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    n_ops: int = 0
    peak_bytes: int = 0
    # FLOPs by the peak rate they run at ("bf16": tensor cores, "f32")
    flops_by_rate: dict = field(default_factory=dict)
    # bytes of the call's arguments, live from its start
    argument_bytes: int = 0
    # meta launches of each kernel
    launches: dict = field(default_factory=dict)

    def add_flops(self, flops: float, rate: str) -> None:
        self.flops += flops
        self.flops_by_rate[rate] = self.flops_by_rate.get(rate, 0.0) + flops


class _Analysis(TorchDispatchMode):
    """Counts every op dispatched on plain tensors while active."""

    def __init__(self, stats: OpStats) -> None:
        super().__init__()
        self.stats = stats
        self.live = 0
        self._storages: dict[int, int] = {}

    # ------------------------------------------------------------------ #
    # live storages
    # ------------------------------------------------------------------ #
    def track(self, t: torch.Tensor) -> int:
        """Follow ``t``'s storage until it is freed; the bytes it added."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def kernel(self, name: str, flops: float, nbytes: float, rate: str) -> None:
        s = self.stats
        s.n_ops += 1
        s.add_flops(flops, rate)
        s.bytes_accessed += nbytes
        s.launches[name] = s.launches.get(name, 0) + 1

    # ------------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # DTensor's sharding propagation runs the op on FakeTensors under a
        # FakeTensorMode: its metadata work, not the step's
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)
        flat = tree_flatten((args, kwargs))[0]
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        if any(_dispatches_itself(t) for t in tensors):
            # DTensor runs its own dispatch with this mode still active:
            # its collectives and local ops come back here on plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self._count(func, args, kwargs, tensors, out, outs)
        return out

    def _count(self, func, args, kwargs, tensors, out, outs) -> None:
        s = self.stats
        s.n_ops += 1
        for t in outs:
            self.track(t)
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in tensors)
                s.collectives.add(kind, nbytes)
                s.bytes_accessed += nbytes
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            s.add_flops(flop_registry[packet](*args, **kwargs, out_val=out), _rate(tensors[0].dtype))
        if func in _NO_BYTES or _is_view(func):
            return
        if func in _GATHERS:
            s.bytes_accessed += 2 * sum(_nbytes(t) for t in outs)
        elif func in _SLICE_WRITES:
            s.bytes_accessed += 2 * sum(_nbytes(t) for t in tensors[1:]
                                        if t.is_floating_point())
        elif func is _aten.copy_.default:
            s.bytes_accessed += _nbytes(tensors[0]) + _nbytes(tensors[1])
        else:
            s.bytes_accessed += (sum(_nbytes(t) for t in tensors)
                                 + sum(_nbytes(t) for t in outs))


def _local_tensors(tree):
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            yield t._local_tensor if hasattr(t, "_local_tensor") else t


def argument_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors (of a
    DTensor, its local shard's): what :func:`analyze` counts as live at
    the start of a call given ``tree``."""
    sizes = {}
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        sizes[st._cdata] = st.nbytes()
    return sum(sizes.values())


def analyze(fn, *args, **kw):
    """``fn(*args, **kw)`` under the analysis: (its result, :class:`OpStats`).

    The arguments' storages (a DTensor's local shard) are live from the
    start; each count is what this rank runs."""
    stats = OpStats()
    mode = _Analysis(stats)
    for t in _local_tensors((args, kw)):
        stats.argument_bytes += mode.track(t)
    cost.add_sink(mode.kernel)
    try:
        with mode:
            result = fn(*args, **kw)
    finally:
        cost.remove_sink(mode.kernel)
    return result, stats
