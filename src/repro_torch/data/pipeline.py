"""Input pipeline — the port's own copy of ``repro/data/pipeline.py``.

Deterministic synthetic token streams with sharded per-host feeding and
background prefetch.  Each host materializes only its slice of the
global batch (``host_slice``), double-buffered by a prefetch thread.  The
synthetic source is seeded per (step, host) exactly as the JAX package
seeds it, so both packages draw the same batches, and restarts reproduce
the stream.  Batches are numpy arrays; the trainer moves them to its
device.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "Prefetcher", "host_slice"]

# how long close() waits for the worker to make and put its last item
_CLOSE_TIMEOUT_S = 30.0


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0


def host_slice(global_batch: int, host_id: int, n_hosts: int) -> slice:
    if global_batch % n_hosts:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_hosts} hosts")
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


class SyntheticTokens:
    """Deterministic synthetic LM batches (tokens, labels[, frontend])."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 n_hosts: int = 1) -> None:
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.sl = host_slice(cfg.global_batch, host_id, n_hosts)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + self.host_id)
        b = self.sl.stop - self.sl.start
        # zipfian-ish marginal over the vocab, like real text
        z = rng.zipf(1.3, size=(b, cfg.seq_len + 1))
        tokens = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering around any batch iterator.

    The worker is a daemon thread; :meth:`close` stops it and joins it,
    so no thread outlives its user."""

    def __init__(self, it, depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - surfaced on get
                self._err = e
                self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def get(self):
        item = self._q.get()
        if item is None and self._err is not None:
            raise self._err
        return item

    def close(self) -> None:
        """Stop the worker and wait for it: each drain of the queue leaves
        room for the item it may be putting, after which it sees the
        stop flag (its source may first have to make one more item).
        Raises if it has not stopped within ``_CLOSE_TIMEOUT_S``."""
        self._stop.set()
        deadline = time.monotonic() + _CLOSE_TIMEOUT_S
        while self._thread.is_alive():
            if time.monotonic() > deadline:
                raise RuntimeError("the prefetch thread did not stop; its source blocks")
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
