"""Read the numbers that decide ``correct`` on many seeds in one process:
the program's, the control's (the reference in the precision below the
configuration's, put in the program's place) and the planted faults'
(``faults.py``: for a batched prefill cell half of the batch and one
slot, read on the program's judged requests; for the training cell
half of each row), each against the float32 reference.  The limits in
``limits/<workload>.json`` are set from these readings.

    python3 chipbench/calibrate.py --workload <name> --seconds <s> --seeds <n> ...
        [--control-seeds <n> ...]

Each seed runs the cell as ``run.py`` does, with a window of ``seconds``;
one JSON line a seed goes to standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chipbench import faults, harness
    harness.set_env(ROOT)
    from chipbench.drivers import prefill_closed, train_steps
    manifest = harness.load_manifest(ROOT)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        ctx = harness.make_ctx(args.workload, seed, args.seconds, False, manifest=manifest)
        driver = prefill_closed if ctx.traffic["kind"] == "prefill_closed" else train_steps
        if driver is prefill_closed and ctx.traffic["clients"] > 1:
            ctx.hooks["planted"] = faults.BATCHED
        record = driver.run(ctx)
        row = {"workload": args.workload, "seed": seed, "program": record["numbers"],
               "setup_s": record["setup_s"], "reference_s": record["reference_s"],
               "window_s": record["window_s"], "tokens": record["tokens"],
               "memory_peak_bytes": record["memory_peak_bytes"]}
        ref = record["readings"]["reference"]
        if driver is prefill_closed:
            slots = row["slots"] = record["readings"]["slots"]
            row["program_rows"] = driver.per_request(record["readings"]["answers"], ref)
            for name, got in record["readings"]["planted"].items():
                row[f"fault_{name}"] = driver.served_numbers(got, ref, slots)
                row[f"fault_{name}_rows"] = driver.per_request(got, ref)
        if seed in args.control_seeds:
            t = time.perf_counter()
            if driver is prefill_closed:
                got = driver.reference_logits(ctx, record["readings"]["sample"], lowp="fp8")
                row["ref_fp8"] = driver.served_numbers(got, ref, slots)
                row["ref_fp8_rows"] = driver.per_request(got, ref)
            else:
                plain = lambda r: {k: v for k, v in r.items() if k != "grad1_sample"}  # noqa: E731
                row["readings"] = {k: plain(v) for k, v in record["readings"].items()}
                for name, kw in (("ref_fp8", {"lowp": "fp8"}), ("ref_bf16", {"lowp": "bf16"}),
                                 ("fault_half_batch", {"drop_half": True})):
                    got = driver.reference_readings(ctx, **kw)
                    row[name] = driver.train_numbers(got, ref)
                    row["readings"][name] = plain(got)
            row["control_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del record, ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())
