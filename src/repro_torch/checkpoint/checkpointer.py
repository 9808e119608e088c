"""Fault-tolerant checkpointing — port of
``repro/checkpoint/checkpointer.py``, in its wire format, so a file
written by either package loads in the other.

* One file per step, ``ckpt_{step:09d}.msgpack``: an 8-byte
  little-endian header length, a JSON header (``leaves``: the ``key``,
  ``shape``, ``dtype``, ``orig_dtype``, ``offset`` and ``nbytes`` of each
  leaf; ``meta``), then the raw blobs.  Key paths are ``/a/b/0/c``, dict
  keys sorted and lists by index (:func:`repro_torch.convert.tree_paths`);
  bf16 travels as ``uint16`` with ``orig_dtype`` "bfloat16".
* Atomic writes: a ``.tmp`` file, then ``os.replace``, so a crash
  mid-save never corrupts the latest checkpoint.
* Async mode: the tree is copied to host memory at once, and written on
  a daemon thread while training goes on; :meth:`Checkpointer.wait`
  joins it.
* Retention of the last ``keep`` checkpoints.

Leaves are torch tensors (any device) or numpy arrays; loads return CPU
tensors in the skeleton's structure.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import tree_paths

__all__ = ["Checkpointer", "save_pytree", "load_pytree", "checkpoint_meta"]


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf that later in-place updates cannot
    reach; bf16 as its ``uint16`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def save_pytree(path, tree, extra_meta: dict | None = None) -> None:
    """Atomically write a tree of tensors or arrays to ``path``."""
    _write(Path(path), _snapshot(tree), extra_meta)


def _snapshot(tree) -> list:
    """``(key, wire array, orig dtype)`` of every leaf, on the host."""
    out = []
    for key, leaf in tree_paths(tree):
        is_bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = _host(leaf)
        out.append((key, arr, "bfloat16" if is_bf16 else str(arr.dtype)))
    return out


def _write(path: Path, leaves: list, extra_meta: dict | None) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    header_items, offset = [], 0
    for key, arr, orig in leaves:
        header_items.append({"key": key, "shape": list(arr.shape), "dtype": str(arr.dtype),
                             "orig_dtype": orig, "offset": offset, "nbytes": arr.nbytes})
        offset += arr.nbytes
    header = json.dumps({"leaves": header_items, "meta": extra_meta or {}}).encode()
    with open(tmp, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for _, arr, _ in leaves:
            f.write(np.ascontiguousarray(arr).tobytes())
    os.replace(tmp, path)


def _read_header(f) -> dict:
    hlen = int.from_bytes(f.read(8), "little")
    return json.loads(f.read(hlen))


def load_pytree(path, skeleton):
    """Load a tree saved by :func:`save_pytree` (of either package) in the
    structure of ``skeleton``, as CPU tensors of the saved dtypes."""
    flat = {}
    with open(Path(path), "rb") as f:
        header = _read_header(f)
        base = f.tell()
        for item in header["leaves"]:
            f.seek(base + item["offset"])
            arr = np.frombuffer(f.read(item["nbytes"]), dtype=item["dtype"]).reshape(
                item["shape"])
            t = torch.from_numpy(arr.copy())
            if item["orig_dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            flat[item["key"]] = t
    return _unflatten_into(skeleton, flat)


def _unflatten_into(skeleton, flat: dict, prefix: str = ""):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}") for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten_into(v, flat, f"{prefix}/{i}")
                              for i, v in enumerate(skeleton))
    return flat[prefix]


def checkpoint_meta(path) -> dict:
    with open(Path(path), "rb") as f:
        return _read_header(f)["meta"]


class Checkpointer:
    """Step-indexed checkpoint directory manager with async saves."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:09d}.msgpack"

    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("ckpt_*.msgpack"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save(self, step: int, tree, extra_meta: dict | None = None) -> None:
        self.wait()
        # snapshot to host now; write now or in the background
        leaves = _snapshot(tree)
        meta = dict(extra_meta or {}, step=step)

        def write():
            _write(self._path(step), leaves, meta)
            self._gc()

        if self.async_save:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def restore(self, skeleton, step: int | None = None):
        """(tree, meta) of ``step`` (default: the latest), or (None, None)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(self._path(step), skeleton), checkpoint_meta(self._path(step))

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            try:
                self._path(s).unlink()
            except FileNotFoundError:
                pass
