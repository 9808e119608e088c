"""Elastic serving on the PyTorch port: mid-step card loss -> warm-start
replan -> serve on.  The counterpart of ``examples/elastic_serving.py``.

1. Loses 8 cards of a 64-card H100 fleet (56 cards, 8 of them degraded;
   the ``h100_fleet_si`` preset's spec rates) serving mixtral_8x7b at 32k
   context *mid-execution*: the failure strikes halfway through the
   simulated step, completed work is frozen, in-flight work is pinned in
   place, and only the residual is replanned (``repro_torch.scenario``
   through ``repro_torch.runtime.rescale_plan``).  Prints the migration
   summary and the stitched Gantt with the event marker.  The step times
   are the scheduler's estimates from spec rates, not measurements.
2. Serves a reduced mixtral on the card (``--device cpu``: on the CPU):
   a prefill of the prompt batch, then greedy decoding, and the flash
   kernel launches the two made (on the card the prefill's attention is
   the flash kernel; decode steps and the CPU run plain torch).

Run:  PYTHONPATH=src python examples/elastic_serving_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, shape_by_name
from repro_torch.core import h100_fleet_si
from repro_torch.core.autoshard import plan
from repro_torch.kernels import flash_attention_bhsd
from repro_torch.launch.serve import greedy_decode, prefill
from repro_torch.models import LM
from repro_torch.runtime import rescale_plan

FLEET = {"h100": 56, "h100-degraded": 8}
KPRIME = [8, 16, 32, 56]


def part1_replan() -> bool:
    print("=== elastic re-planning after a mid-step card loss ===")
    cfg = get_config("mixtral_8x7b")
    shape = shape_by_name("decode_32k")
    fleet = h100_fleet_si(FLEET)

    # probe the healthy step time to place the failure mid-step
    healthy = plan(cfg, shape, fleet, kprime=KPRIME)
    if healthy is None:
        print("infeasible before failure")
        return False
    t_fail = 0.5 * healthy.est_step_s

    report = rescale_plan(cfg, shape, fleet, failed=set(range(8)), at=t_fail,
                          policy="pinned-warm-start", kprime=KPRIME)
    tl = report.timeline
    print(f"fleet: {fleet.k} H100 cards -> lost 8 at t={t_fail * 1e3:.2f} ms (mid-step)")
    print(f"est step before: {report.est_step_before_s * 1e3:.2f} ms")
    if not report.feasible:
        print("infeasible on survivors -> needs a bigger fleet")
        print("diagnosis:", report.infeasibility)
        return False
    print(f"est step after:  {report.est_step_after_s * 1e3:.2f} ms")
    print(f"stitched finish: {tl.makespan * 1e3:.2f} ms")
    print(f"new plan valid:  {report.new_plan.valid}")
    m = tl.migrations[0]
    print(f"migration: {m.moved_tasks} moved, {m.displaced_tasks} displaced (lost cards), "
          f"{m.restarted_tasks} in-flight restarted (lost work {m.lost_work:.3g} FLOP)")
    for frm, to, n in m.moves[:6]:
        print(f"    {n:4d} task(s)  {frm} -> {to}")
    if len(m.moves) > 6:
        print(f"    ... {len(m.moves) - 6} more routes")
    print()
    print(tl.gantt(width=64))
    print()
    return report.new_plan.valid


def part2_serve(device: str) -> bool:
    print(f"=== serving a reduced mixtral ({device}): prefill, then greedy decode ===")
    cfg = get_smoke_config("mixtral_8x7b")
    # a capacity no token overflows: the prefill routes the batch as one group,
    # decode each token alone, and both then keep every token
    model = LM(cfg, param_dtype=torch.float32, attn_chunk=16, max_seq=64,
               capacity_factor=16.0, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))).to(device)
    before = dict(flash_attention_bhsd.variant_launches)
    first = prefill(model, prompt).argmax(dim=-1)
    out = greedy_decode(model, prompt, new_tokens=8)
    launches = {k: n - before[k] for k, n in flash_attention_bhsd.variant_launches.items()
                if n > before[k]}
    print("generated:", out.cpu().tolist())
    agree = bool(torch.equal(out[:, 0], first))
    print(f"first token agrees with the prefill: {agree}")
    print(f"flash launches: {launches}")
    return agree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    ok = part1_replan()
    ok = part2_serve(args.device) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
