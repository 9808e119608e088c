"""Closed-loop prefill: ``clients`` clients, each with one prompt of
``prompt_len`` token ids outstanding, all prefilled together as one
``[clients, prompt_len]`` batch by ``launch/serve.prefill``; each client
sends its next prompt as soon as its last-position logits reach the
host.

Prompts are uniform over the vocabulary, drawn on the device from
(seed, call).  Set-up ends after ``warmup_calls`` calls at the cell's
own shape.  The window runs from the first submission to the end of the
last call submitted before ``seconds`` had passed: every request it
submitted is in it.  A request's latency runs from its submission to
its logits on the host.

Once the window has closed, ``sample_requests`` of the finished
requests, as many from each batch slot and drawn from the seed, are
prefilled by the float32 reference, and each served answer is read: the
gap by which the logit of the program's first token lies below the
reference's best, and the largest gap between any of the program's
logits and the reference's, over the spread of the reference's logits
(:func:`served_numbers`).
"""
from __future__ import annotations

import gc
import math
import random
import statistics
import time

import torch

from chipbench import program, weights
from chipbench.trace import SubWindow, Tracer

__all__ = ["run", "per_request", "prompts", "reference_logits", "sample", "served_numbers"]


def prompts(ctx, call: int) -> torch.Tensor:
    """The ``[clients, prompt_len]`` prompts of call ``call`` (negative:
    warm-up)."""
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(weights.leaf_seed(ctx.seed, "prompts", call))
    shape = (ctx.traffic["clients"], ctx.traffic["prompt_len"])
    return torch.randint(0, ctx.model["vocab_size"], shape, generator=gen, device=ctx.device)


def per_request(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """Float32 logits ``got`` against ``ref``, both ``[N, V]``: each row's
    gap by which the logit of ``got``'s first token lies below ``ref``'s
    best, and its largest logit gap over the spread of ``ref``'s row."""
    first = got.argmax(dim=-1)
    gap = ref.max(dim=-1).values - ref.gather(1, first[:, None])[:, 0]
    err = (got - ref).abs().amax(dim=-1) / ref.std(dim=-1)
    return gap.tolist(), err.tolist()


def served_numbers(got: torch.Tensor, ref: torch.Tensor, slots: list) -> dict:
    """The rows' readings: the worst row's gaps (``argmax_gap``,
    ``logit_err``), the logit gap of the median row and of the best
    (``logit_err_median``, ``logit_err_min``), and ``slot_err_min``: the
    largest, over the batch slots ``slots`` of the rows, of the slot's
    best row's logit gap.  A fault confined to some slots moves
    ``slot_err_min`` where the best row's gap does not.  A cell's limits
    file names the ones it compares."""
    gap, err = per_request(got, ref)
    best = {}
    for slot, e in zip(slots, err):
        best[slot] = min(e, best.get(slot, math.inf))
    return {"argmax_gap": max(gap), "logit_err": max(err),
            "logit_err_median": statistics.median(err), "logit_err_min": min(err),
            "slot_err_min": max(best.values())}


def _window(ctx, model, prefill):
    """Run calls until ``ctx.seconds`` have passed; the window's record."""
    clock = time.perf_counter
    bsz, seq = ctx.traffic["clients"], ctx.traffic["prompt_len"]
    lat_ms, answers, calls = [], [], 0
    gc.collect()
    gc.freeze()
    t0 = t_close = clock()
    sub = SubWindow(t0, ctx.seconds, program.flash_launches) if ctx.trace else None
    while True:
        tokens = prompts(ctx, calls)
        submit = clock()
        if submit >= t0 + ctx.seconds:
            break
        if sub:
            sub.open_if_due(submit)
        with torch.profiler.record_function("chipbench.prefill"):
            logits = prefill(model, tokens)
        with torch.profiler.record_function("chipbench.to_host"):
            answers.append(logits.float().cpu())
        t_close = clock()
        calls += 1
        lat_ms.extend([(t_close - submit) * 1e3] * bsz)
        if sub:
            sub.count(t_close, bsz * seq)
    gc.unfreeze()
    return {"window_s": t_close - t0, "calls": calls, "tokens": calls * bsz * seq,
            "latencies_ms": lat_ms, "answers": answers, "trace": sub and sub.record()}


def run(ctx) -> dict:
    bsz, seq = ctx.traffic["clients"], ctx.traffic["prompt_len"]
    from repro_torch.launch import serve
    phases = [("imports_s", ctx.mark())]
    prefill = ctx.hooks.get("prefill", lambda f: f)(serve.prefill)
    model = program.build_lm(ctx.config, ctx.seed, seq, ctx.device)
    phases.append(("weights_s", ctx.mark()))
    for w in range(ctx.traffic["warmup_calls"]):
        prefill(model, prompts(ctx, -1 - w)).float().cpu()
    if ctx.trace:
        Tracer.warm()
    phases.append(("warmup_s", ctx.mark()))
    setup_s = time.perf_counter() - ctx.t_start
    win = _window(ctx, model, prefill)
    peak = ctx.peak_bytes()
    answers = torch.cat(win["answers"])                  # [requests, V]
    idx = sample(ctx, answers.shape[0])
    planted = {name: _replay(ctx, model, wrap(prefill), idx)
               for name, wrap in ctx.hooks.get("planted", {}).items()}
    del model
    ctx.free()
    failed = int((~torch.isfinite(answers).all(dim=-1)).sum())
    record = {"kind": "prefill", "model": ctx.model, "seq_len": seq, "batch": bsz,
              "setup_s": setup_s, "window_s": win["window_s"], "tokens": win["tokens"],
              "calls": win["calls"], "latencies_ms": win["latencies_ms"],
              "attempted": answers.shape[0], "failed": failed, "memory_peak_bytes": peak,
              "setup_split": ctx.split(phases)}
    if win["trace"]:
        record["trace"] = win["trace"]
    t_ref = time.perf_counter()
    ref = reference_logits(ctx, idx)
    slots = [i % bsz for i in idx]
    record["numbers"] = served_numbers(answers[idx], ref, slots)
    record["reference_s"] = time.perf_counter() - t_ref
    record["readings"] = {"sample": idx, "slots": slots, "reference": ref,
                          "answers": answers[idx], "planted": planted}
    return record


def sample(ctx, n_requests: int) -> list:
    """The judged requests' indices, drawn from the seed: from each of the
    ``clients`` batch slots, ``sample_requests / clients`` of the requests
    it served (at least one, at most all)."""
    bsz = ctx.traffic["clients"]
    per_slot = max(1, ctx.traffic["sample_requests"] // bsz)
    rng = random.Random(ctx.seed)
    idx = []
    for slot in range(bsz):
        own = range(slot, n_requests, bsz)
        idx += rng.sample(own, min(per_slot, len(own)))
    return sorted(idx)


def _replay(ctx, model, prefill, idx: list) -> torch.Tensor:
    """The answers [len(idx), V] (host float32) that ``prefill`` gives
    requests ``idx``, their calls run again: a planted fault's, read on
    the program's judged requests (``hooks["planted"]``)."""
    bsz = ctx.traffic["clients"]
    rows = {}
    for call in sorted({i // bsz for i in idx}):
        out = prefill(model, prompts(ctx, call)).float().cpu()
        rows.update({i: out[i % bsz] for i in idx if i // bsz == call})
    return torch.stack([rows[i] for i in idx])


def reference_logits(ctx, idx: list, lowp: str | None = None) -> torch.Tensor:
    """The reference's last-position logits [len(idx), V] (host float32)
    of requests ``idx``, their prompts drawn again from the seed; in
    ``lowp`` for the control."""
    from chipbench.reference import Reference, exact_float32
    exact_float32()
    bsz = ctx.traffic["clients"]
    tokens = torch.stack([prompts(ctx, i // bsz)[i % bsz] for i in idx])
    ref = Reference(ctx.model, ctx.seed, capacity_factor=ctx.config["capacity_factor"],
                    device=ctx.device, lowp=lowp,
                    weight_dtype=weights.DTYPES[ctx.config["param_dtype"]])
    return ref.last_logits(tokens).float().cpu()
