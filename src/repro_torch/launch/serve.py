"""Serving launcher — port of ``repro/launch/serve.py``.

Default: serve a reduced config (prefill a prompt batch, then
greedy-decode).  ``--production [--shape decode_32k]`` is JAX's: the
full-size cell's dry run on the production mesh
(:func:`repro_torch.launch.dryrun.run_cell`: the serve or prefill step on
meta tensors over a fake group of 256 ranks, analysed per rank; no card
is needed), its cell written under ``experiments/dryrun_torch/``; it
exits 0 exactly when the cell's status is ``"ok"``.  ``--full-size``
serves the full config for real on the device, with bf16 parameters
drawn from seed 0, once it has checked that they fit the device's memory
(:func:`check_fits`: whole jamba_15_large and llama32_vision_90b do not
fit one card).  Archs with a frontend (the VLM's patch embeddings, the
encoder-decoder's speech frames) get stub frontend embeddings drawn after
the prompt from the same generator, as in JAX.

Example::

    python -m repro_torch.launch.serve --arch llama3_8b --device cpu
    python -m repro_torch.launch.serve --arch llama3_8b --production
    python -m repro_torch.launch.serve --arch llama3_8b --full-size
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import LM
from repro_torch.models.layers import resolve_device

__all__ = ["prefill", "greedy_decode", "check_fits", "main"]

_log = logging.getLogger(__name__)


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, frontend=None) -> torch.Tensor:
    """Last-position logits [B, V] of a prompt batch (the JAX prefill
    step's body), with the request batch's ``frontend`` embeddings where
    the arch has a frontend.  Like it, this fills no KV cache."""
    return model(tokens, frontend, last_only=True)[:, -1]


@torch.no_grad()
def greedy_decode(model: LM, prompt: torch.Tensor, new_tokens: int,
                  frontend=None) -> torch.Tensor:
    """Prefill via teacher-forced decode steps, then greedy generation.
    The cross-attention memory of ``frontend`` is encoded once and read
    by every step.

    Returns the generated tokens [B, new_tokens]."""
    bsz, plen = prompt.shape
    max_len = plen + new_tokens + 1
    cache = model.init_cache(bsz, max_len, dtype=torch.float32)
    memory = model.encode_memory(frontend)
    logits = None
    for t in range(plen):
        logits, cache = model.decode_step(cache, prompt[:, t:t + 1], t, memory=memory)
    out = []
    tok = logits[:, -1:].argmax(dim=-1)
    for t in range(plen, plen + new_tokens):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok, t, memory=memory)
        tok = logits[:, -1:].argmax(dim=-1)
    return torch.cat(out, dim=1)


def _device_memory_bytes(device: torch.device) -> int:
    """What ``device`` holds: the card's memory, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg, device: torch.device) -> None:
    """Raise ``ValueError`` before anything is allocated when ``cfg``'s bf16
    weights alone exceed the device's memory (whole jamba_15_large and
    llama32_vision_90b do not fit one card)."""
    need = cfg.total_params() * 2
    have = _device_memory_bytes(device)
    if need > have:
        raise ValueError(f"{cfg.name}: its bf16 weights take {need} bytes "
                         f"({need / 1e9:.1f} GB), more than the {have} bytes of {device}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not logging.getLogger().handlers:     # CLI: bare messages on stdout
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stdout)

    if args.production:
        from repro_torch.launch.dryrun import run_production
        return run_production(args.arch, args.shape)
    if args.full_size:
        cfg = get_config(args.arch)
        check_fits(cfg, resolve_device(args.device))
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
    frontend = None
    if cfg.frontend_tokens:
        frontend = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.frontend_tokens, cfg.frontend_dim)),
            dtype=torch.float32, device=device)

    t0 = time.perf_counter()
    logits = prefill(model, prompt, frontend)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        _log.error("prefill logits are not finite")
        return 1
    _log.info("prefill %s tokens in %.3fs (%.1f tok/s) on %s",
              tuple(prompt.shape), t_prefill, prompt.numel() / t_prefill,
              device)

    t0 = time.perf_counter()
    out = greedy_decode(model, prompt, args.tokens, frontend)
    _sync(device)
    dt = time.perf_counter() - t0
    _log.info("generated %s tokens in %.3fs (%.1f tok/s) on %s",
              tuple(out.shape), dt, args.batch * args.tokens / dt, device)
    _log.info("sample: %s", out[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
