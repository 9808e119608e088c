"""Plain float32 AdamW with global-norm clipping and the warmup-cosine
learning-rate scale, as the port documents its optimizer: the gradients
clipped to a global norm of ``clip``, the step counted before the bias
corrections, decoupled weight decay on the weights (Loshchilov and
Hutter, arXiv:1711.05101), and a scale that rises linearly over
``warmup`` steps from 0, then falls on a cosine to ``min_frac``."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["AdamW", "lr_scale"]


def lr_scale(step: int, warmup: int, total: int, min_frac: float = 0.1) -> float:
    """The scale of step ``step`` (0 for the first)."""
    if step < warmup:
        return step / max(warmup, 1)
    progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return min_frac + (1.0 - min_frac) * 0.5 * (1.0 + math.cos(math.pi * progress))


@dataclass
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0
    warmup: int = 10
    total: int = 20

    def init(self, params: dict) -> dict:
        return {"step": 0, "m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: dict, state: dict) -> dict:
        """Update ``params`` in place from their ``.grad``; returns the
        clipped gradients' norms by leaf."""
        grads = {n: p.grad for n, p in params.items()}
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        scale = min(1.0, self.clip / max(norm, 1e-9))
        lr = self.lr * lr_scale(state["step"], self.warmup, self.total)
        state["step"] += 1
        t = state["step"]
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        norms = {}
        for n, p in params.items():
            norms[n] = float(grads[n].double().norm()) * scale
            # a slice of the first dim at a time: few temporaries at once
            for i in range(0, p.shape[0], max(1, p.shape[0] // 8)):
                sl = slice(i, i + max(1, p.shape[0] // 8))
                g = grads[n][sl] * scale
                m, v, w = state["m"][n][sl], state["v"][n][sl], p[sl]
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                update = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
                w.sub_(update.add_(w, alpha=self.weight_decay).mul_(lr))
            p.grad = None
        return norms
