"""Batched serving loop — port of ``repro/runtime/serve_loop.py``.

A fixed pool of ``slots`` (the batch dimension of the decode step),
requests admitted the moment a slot frees up, per-slot cache cursors,
greedy decode until EOS / max-tokens / ``max_len``, slot recycled.  One
decode step serves the whole pool every iteration regardless of request
boundaries.  Prompts are fed through the decode step one token at a
time, as in the JAX loop.

Restriction: attention-cache architectures only (Mamba/RWKV slots would
need per-slot state resets).  MoE layers keep no per-slot state: the
decode step routes each slot's token on its own.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import LM

__all__ = ["Request", "ServeLoop"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [P] int32
    max_new_tokens: int = 16
    eos_id: int = -1                    # -1: never stops early
    out: list = field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Continuous-batching server over ``model`` on the model's device."""

    def __init__(self, model: LM, *, slots: int = 4,
                 max_len: int = 64) -> None:
        if any(s.kind != "attn" for s in model.specs):
            raise ValueError(
                "continuous batching requires attention caches "
                "(stateful SSM/RWKV slots need per-slot state resets)")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        # f32 cache under the model's param dtype, as in the JAX loop
        self.cache = model.init_cache(slots, max_len, dtype=torch.float32)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        # per-slot cursor: index the next token will be written at
        self.pos = np.zeros(slots, np.int32)
        self.tokens = np.zeros((slots, 1), np.int32)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self.pos[s] = 0
                self.tokens[s, 0] = req.prompt[0]

    def _advance_slot(self, s: int, logits: np.ndarray) -> None:
        req = self.active[s]
        if req is None:
            self.pos[s] = 0           # idle slots rewrite position 0
            return
        p = int(self.pos[s])
        plen = len(req.prompt)
        if p + 1 < plen:                       # still prefilling
            self.tokens[s, 0] = req.prompt[p + 1]
        else:                                  # generating
            tok = int(np.argmax(logits))
            req.out.append(tok)
            self.tokens[s, 0] = tok
            if (len(req.out) >= req.max_new_tokens
                    or tok == req.eos_id
                    or p + 2 >= self.max_len):
                req.done = True
                self.active[s] = None
                self.pos[s] = 0
                return
        self.pos[s] = p + 1

    @torch.no_grad()
    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Serve until queue + slots drain; returns finished requests."""
        device = self.model.device
        finished: list[Request] = []
        steps = 0
        while (any(r is not None for r in self.active)
               or self.queue) and steps < max_steps:
            self._admit()
            logits, self.cache = self.model.decode_step(
                self.cache, torch.as_tensor(self.tokens, device=device),
                torch.as_tensor(self.pos, device=device))
            logits_np = logits[:, -1].cpu().numpy()
            for s in range(self.slots):
                before = self.active[s]
                self._advance_slot(s, logits_np[s])
                if before is not None and before.done:
                    finished.append(before)
            steps += 1
        return finished
