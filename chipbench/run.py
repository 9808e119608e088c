"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers that decided ``correct`` close it and
standard error, each beside its limit.  The exit code is not 0, and no
result is printed, without a card, with fewer cards than the cell asks
for, without the program, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    from chipbench import harness
    harness.set_env(ROOT)
    manifest = harness.load_manifest(ROOT)
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"chipbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    ctx = harness.make_ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                           manifest=manifest, t_start=T_START)
    result = harness.run_cell(ctx, manifest)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"chipbench: loaded JAX or the JAX package: {foreign}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
