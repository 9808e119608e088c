"""Serving launcher — port of ``repro/launch/serve.py``.

Default: serve a reduced config (prefill a prompt batch, then
greedy-decode).  ``--production`` serves the full config for real on the
card, with bf16 parameters drawn from seed 0; the JAX launcher only
lowers a dry run there, which has no torch form.

Example::

    python -m repro_torch.launch.serve --arch llama3_8b --device cpu
    python -m repro_torch.launch.serve --arch llama3_8b --production
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import LM

__all__ = ["prefill", "greedy_decode", "main"]

_log = logging.getLogger(__name__)


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Last-position logits [B, V] of a prompt batch (the JAX prefill
    step's body).  Like it, this fills no KV cache."""
    return model(tokens, last_only=True)[:, -1]


@torch.no_grad()
def greedy_decode(model: LM, prompt: torch.Tensor,
                  new_tokens: int) -> torch.Tensor:
    """Prefill via teacher-forced decode steps, then greedy generation.

    Returns the generated tokens [B, new_tokens]."""
    bsz, plen = prompt.shape
    max_len = plen + new_tokens + 1
    cache = model.init_cache(bsz, max_len, dtype=torch.float32)
    logits = None
    for t in range(plen):
        logits, cache = model.decode_step(cache, prompt[:, t:t + 1], t)
    out = []
    tok = logits[:, -1:].argmax(dim=-1)
    for t in range(plen, plen + new_tokens):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok, t)
        tok = logits[:, -1:].argmax(dim=-1)
    return torch.cat(out, dim=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not logging.getLogger().handlers:     # CLI: bare messages on stdout
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stdout)

    if args.production:
        cfg = get_config(args.arch)
        model = LM(cfg, seed=0, device=args.device)
    else:
        cfg = get_smoke_config(args.arch)
        model = LM(cfg, param_dtype=torch.float32, attn_chunk=16,
                   max_seq=args.prompt_len + args.tokens + 8, seed=0,
                   device=args.device)
    device = model.device
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=device)

    t0 = time.perf_counter()
    logits = prefill(model, prompt)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        _log.error("prefill logits are not finite")
        return 1
    _log.info("prefill %s tokens in %.3fs (%.1f tok/s) on %s",
              tuple(prompt.shape), t_prefill, prompt.numel() / t_prefill,
              device)

    t0 = time.perf_counter()
    out = greedy_decode(model, prompt, args.tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    _log.info("generated %s tokens in %.3fs (%.1f tok/s) on %s",
              tuple(out.shape), dt, args.batch * args.tokens / dt, device)
    _log.info("sample: %s", out[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
