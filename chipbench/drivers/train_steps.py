"""Training steps: back-to-back steps of ``batch`` x ``seq_len`` token
ids through ``Trainer.step_fn`` (loss, backward, AdamW), with no
checkpoint written.

Each step's rows are uniform token ids over the vocabulary, drawn on the
device from (seed, step): every step's rows differ.  Set-up builds the
trainer, drives its first ``checked_steps`` steps through the window's
own call and feed, and keeps what the check needs of them: each step's
loss, every leaf's norm of the first gradient as the optimizer got it
(its first moment over 1 - b1, after one step) with its values at a
sample of entries, and every leaf's norm of its change after the checked
steps (the master weights against the
weights drawn from the seed).  The window then runs steps until
``seconds`` have passed; every step it started is in it.

Once the window has closed and the program's state is freed, the
float32 reference follows the checked steps from the same weights and
rows, and :func:`train_numbers` sets the two sides' readings side by
side.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from chipbench import program, weights
from chipbench.trace import SubWindow, Tracer

__all__ = ["run", "batch", "reference_readings", "train_numbers"]


def batch(ctx, step: int) -> dict:
    """Step ``step``'s tokens and next-token labels, on the device."""
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(weights.leaf_seed(ctx.seed, "batch", step))
    rows = torch.randint(0, ctx.model["vocab_size"],
                         (ctx.traffic["batch"], ctx.traffic["seq_len"] + 1),
                         generator=gen, device=ctx.device)
    return {"tokens": rows[:, :-1].contiguous(), "labels": rows[:, 1:].contiguous()}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


@torch.no_grad()
def _change_norms(ctx, leaves: dict) -> dict:
    """Each float32 leaf's distance from the weights drawn from the seed,
    a layer's slice at a time."""
    out = {}
    dtype = weights.DTYPES[ctx.config["param_dtype"]]
    for name, t in leaves.items():
        if name.startswith("blocks."):
            sq = sum(_norm(t[r] - weights.draw(ctx.seed, name, r, t.shape[1:], dtype,
                                                t.device).float()) ** 2
                     for r in range(t.shape[0]))
        else:
            sq = _norm(t - weights.draw(ctx.seed, name, None, t.shape, dtype,
                                        t.device).float()) ** 2
        out[name] = math.sqrt(sq)
    return out


# entries of each leaf's first gradient that the check compares one by one
GRAD_SAMPLE = 1 << 20


def _grad_sample(ctx, moments: dict, b1: float) -> dict:
    """Each leaf's first clipped gradient (its first moment over 1 - b1,
    after one step) at up to ``GRAD_SAMPLE`` entries drawn from the seed,
    as host float32 vectors."""
    out = {}
    for name, m in moments.items():
        flat = m.reshape(-1)
        if flat.numel() > GRAD_SAMPLE:
            gen = torch.Generator(device=flat.device)
            gen.manual_seed(weights.leaf_seed(ctx.seed, f"grad_sample/{name}", None))
            flat = flat[torch.randint(0, flat.numel(), (GRAD_SAMPLE,), generator=gen,
                                      device=flat.device)]
        out[name] = (flat.float() / (1.0 - b1)).cpu()
    return out


def _rel_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the worst checked step's loss gap over the reference's
    loss; ``grad_gap`` and ``change_gap`` by :func:`_rel_gap`, the change
    over the leaves whose reference gradient is at least a thousandth of
    the median leaf's; ``grad_diff`` (worst leaf) and ``grad_diff_median``
    (median leaf): the distance between the two first gradients at the
    sampled entries, over the reference's norm there."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moved = [n for n in names if ref["grad1"][n] >= 1e-3 * med]
    diff = [float(torch.linalg.vector_norm(prog["grad1_sample"][n] - ref["grad1_sample"][n])
                  / torch.linalg.vector_norm(ref["grad1_sample"][n]).clamp(min=1e-30))
            for n in moved]
    return {"loss_gap": loss_gap,
            "grad_gap": _rel_gap(prog["grad1"], ref["grad1"], names),
            "change_gap": _rel_gap(prog["change"], ref["change"], moved),
            "grad_diff": max(diff), "grad_diff_median": statistics.median(diff)}


def reference_readings(ctx, lowp: str | None = None, drop_half: bool = False) -> dict:
    """The reference's losses, first clipped gradient norms and changes
    over the checked steps; in ``lowp`` for the control; ``drop_half``
    trains on the first half of each row only (a planted fault)."""
    from chipbench.reference import AdamW, Reference, exact_float32
    exact_float32()
    ref = Reference(ctx.model, ctx.seed, capacity_factor=ctx.config["capacity_factor"],
                    device=ctx.device, lowp=lowp,
                    weight_dtype=weights.DTYPES[ctx.config["param_dtype"]])
    params = ref.train_params()
    opt = AdamW(total=max(ctx.traffic["schedule_steps"], 20))
    state = opt.init(params)
    out = {"losses": []}
    for i in range(ctx.traffic["checked_steps"]):
        b = batch(ctx, i)
        if drop_half:
            half = b["tokens"].shape[1] // 2
            b = {k: v[:, :half] for k, v in b.items()}
        loss = ref.loss(params, b["tokens"], b["labels"])
        loss.backward()
        out["losses"].append(float(loss.detach()))
        norms = opt.step(params, state)
        if i == 0:
            out["grad1"] = norms
            out["grad1_sample"] = _grad_sample(ctx, state["m"], opt.b1)
    out["change"] = _change_norms(ctx, {n: p.detach() for n, p in params.items()})
    del params, state
    return out


class _Marks:
    """``step_fn``'s ``mark`` hook: CUDA events at each phase."""

    def __init__(self) -> None:
        self.steps: list = []

    def __call__(self, name: str) -> None:
        if name == "forward":
            self.steps.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev

    def adamw_ms(self) -> list:
        return [s["adamw"].elapsed_time(s["end"]) for s in self.steps]


def run(ctx) -> dict:
    from repro_torch.convert import flatten_tree
    clock = time.perf_counter
    bsz, seq = ctx.traffic["batch"], ctx.traffic["seq_len"]
    phases = [("imports_s", ctx.mark())]
    trainer = program.build_trainer(ctx.config, ctx.seed, bsz, seq,
                                    ctx.traffic["schedule_steps"], ctx.device)
    phases.append(("weights_s", ctx.mark()))
    params, opt, _ = trainer.init_or_restore()
    phases.append(("optimizer_s", ctx.mark()))
    step = ctx.hooks.get("step", lambda f: f)(trainer.step_fn)
    b1 = trainer.tcfg.opt.b1
    prog = {"losses": []}
    aside = 0.0                     # the check's own reading, not set-up
    for i in range(ctx.traffic["checked_steps"]):
        params, opt, met = step(params, opt, batch(ctx, i))
        prog["losses"].append(float(met["loss"]))
        if i == 0:
            t = clock()
            moments = flatten_tree(opt["m"])
            prog["grad1"] = {n: _norm(m) / (1.0 - b1) for n, m in moments.items()}
            prog["grad1_sample"] = _grad_sample(ctx, moments, b1)
            del moments
            aside += clock() - t
    t = clock()
    prog["change"] = _change_norms(ctx, flatten_tree(opt["master"]))
    aside += clock() - t
    if ctx.trace:
        Tracer.warm()
    phases.append(("checked_steps_s", ctx.mark() - aside))
    setup_s = clock() - ctx.t_start - aside

    losses, steps = [], ctx.traffic["checked_steps"]
    gc.collect()
    gc.freeze()
    t0 = t_close = clock()
    sub = SubWindow(t0, ctx.seconds, program.flash_launches) if ctx.trace else None
    marks = _Marks()
    while True:
        rows = batch(ctx, steps)
        submit = clock()
        if submit >= t0 + ctx.seconds:
            break
        traced = sub is not None and sub.open_if_due(submit)
        with torch.profiler.record_function("chipbench.train_step"):
            params, opt, met = step(params, opt, rows, mark=marks if traced else None)
        with torch.profiler.record_function("chipbench.loss_to_host"):
            losses.append(float(met["loss"]))
        t_close = clock()
        steps += 1
        if sub:
            sub.count(t_close, bsz * seq)
    gc.unfreeze()
    trace = sub and sub.record()
    peak = ctx.peak_bytes()
    del trainer, params, opt, met
    ctx.free()
    record = {"kind": "train", "model": ctx.model, "seq_len": seq, "batch": bsz,
              "setup_s": setup_s, "window_s": t_close - t0, "tokens": len(losses) * bsz * seq,
              "attempted": len(losses), "failed": sum(not math.isfinite(x) for x in losses),
              "memory_peak_bytes": peak, "setup_split": ctx.split(phases)}
    if trace:
        record["trace"] = {**trace, "adamw_ms": marks.adamw_ms()}
    t_ref = clock()
    ref = reference_readings(ctx)
    record["numbers"] = train_numbers(prog, ref)
    record["reference_s"] = clock() - t_ref
    record["readings"] = {"program": prog, "reference": ref}
    return record
