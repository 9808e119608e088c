#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card.

For iterating on one path of the PyTorch port without the whole script:
the kernels are built first, then each named phase runs in order.  A
phase that raises is reported with its traceback and the card's peak
memory, and the phases after it still run.  The exit code is the number
of phases that failed.

    python3 tools/chip_phases.py steps_prefill steps_train
    python3 tools/chip_phases.py vision_train --vision-cut 2 2

Phases: ``steps_prefill``, ``steps_decode`` (after ``steps_prefill``, on
its model), ``steps_train``, ``steps_rwkv_train``, ``jamba_train``,
``vision_train``, ``dryrun_steps`` (after the first three, whose rows it
reads), ``production_dryrun``, ``pipeline``.  ``--vision-cut LAYERS PERIOD`` trains vision at another
depth and ``cross_attn_period`` than ``chip_smoke.VISION_TRAIN_CUT``.
The step phases take the Trainer's step time they are set beside as
``--trainer-step-s`` (the ratio is reported, not checked).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

PHASES = ("steps_prefill", "steps_decode", "steps_train", "steps_rwkv_train",
          "jamba_train", "vision_train", "dryrun_steps", "production_dryrun", "pipeline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--vision-cut", nargs=2, type=int, metavar=("LAYERS", "PERIOD"))
    ap.add_argument("--trainer-step-s", type=float, default=float("nan"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return len(args.phases)
    if args.vision_cut:
        cs.VISION_TRAIN_CUT = dict(n_layers=args.vision_cut[0],
                                   cross_attn_period=args.vision_cut[1])
    print(cs.phase_env(), flush=True)
    cs.phase_build()
    llama, rwkv = cs.get_config("llama3_8b"), cs.get_config("rwkv6_1b6")
    mesh = cs.make_local_mesh(1, 1)
    held = {}

    def prefill():
        held["model"], held["prefill"] = cs.phase_steps_prefill(llama, mesh)

    def decode():
        held["decode"] = cs.phase_steps_decode(held.pop("model"), mesh)

    def train():
        held["train"] = cs.phase_steps_train(llama, mesh, args.trainer_step_s)
    runs = {"steps_prefill": prefill,
            "steps_decode": decode,
            "steps_train": train,
            "steps_rwkv_train": lambda: cs.phase_steps_rwkv_train(rwkv, mesh,
                                                                  args.trainer_step_s),
            "jamba_train": lambda: cs.phase_jamba_train(cs.get_config("jamba_15_large")),
            "vision_train": lambda: cs.phase_vision_train(
                cs.get_config("llama32_vision_90b")),
            "dryrun_steps": lambda: cs.phase_dryrun_steps(llama, held["prefill"],
                                                          held["decode"], held["train"]),
            "production_dryrun": cs.phase_production_dryrun,
            "pipeline": lambda: cs.phase_pipeline(llama)}
    failed = 0
    for name in args.phases:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ok = True
        try:
            runs[name]()
        except Exception:
            traceback.print_exc()
            ok = False
            failed += 1
        print(json.dumps({"phase_run": name, "ok": ok, "seconds": time.perf_counter() - t0,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
              flush=True)
        if name != "steps_prefill":
            cs.free()
    return failed


if __name__ == "__main__":
    sys.exit(main())
