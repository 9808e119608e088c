#!/usr/bin/env python3
"""Run one benchmark cell traced, and report where its device time went
by the program's device spans.

    python3 tools/span_window.py --workload <name> --seed <n> --seconds <s> [--out FILE]

On a card, from the root of a checkout.  The cell runs as
``chipbench/run.py --trace 1`` runs it, and the traced sub-window's
profiler trace is also read whole by ``chipbench/spans.py``.  One JSON
object is printed (and written to ``FILE``): the cell's traced result
line, its end-to-end metrics read from the same run (the cost of
tracing, beside an untraced run of the same seed), device seconds by
span and per traced call or step, idle seconds by span, and the
program's ``moe.*`` counters.  A checkout whose program opens no span
reports none.
"""
import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chipbench import harness, spans, trace
    harness.set_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("span_window: needs a CUDA card", file=sys.stderr)
        return 3
    kept = []

    class KeepingTracer(trace.Tracer):
        """The benchmark's tracer, also reading the whole exported trace."""

        def read(self):
            fd, path = tempfile.mkstemp(suffix=".json", prefix="span_window_")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    raw = json.load(f)
            finally:
                os.remove(path)
            self._prof = None
            kept.append(spans.summarize_spans(raw))
            return trace.read_events(raw)

    trace.Tracer = KeepingTracer
    manifest = harness.load_manifest(ROOT)
    ctx = harness.make_ctx(args.workload, args.seed, args.seconds, True, manifest=manifest)
    driver = importlib.import_module(f"chipbench.drivers.{ctx.traffic['kind']}")
    record = driver.run(ctx)
    line = harness.result_line(ctx, manifest, record)
    end_to_end = {s["name"]: harness.read_metric(s["name"], record)
                  for s in harness.metrics_for(manifest, args.workload, False)}
    sp = kept[-1] if kept else {}
    calls = (record.get("trace") or {}).get("calls") or 0
    per_call_ms = {name: 1e3 * v["inclusive"] / calls
                   for name, v in sp.get("span_s", {}).items()} if calls else {}
    from repro_torch.obs.metrics import METRICS
    counters = {k: v for k, v in METRICS.snapshot()["counters"].items() if k.startswith("moe.")}
    out = {"workload": args.workload, "seed": args.seed, "device": line["device"],
           "end_to_end": end_to_end, "per_layer": line["metrics"],
           "traced_calls": calls, "spans": sp, "span_ms_per_call": per_call_ms,
           "counters": counters, "breakdown": line.get("breakdown"),
           "correct": line["correct"], "checks": line["checks"]}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
