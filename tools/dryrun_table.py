#!/usr/bin/env python3
"""Print the dry run's cells as a markdown table.

Reads the cells ``python -m repro_torch.launch.dryrun --all --both-meshes``
writes under ``experiments/dryrun_torch/`` and prints one row per
(arch, shape): per-rank GiB, whether it fits the card's HBM, the dominant
roofline term and the useful FLOP fraction, each as "16 x 16 value /
2 x 16 x 16 value"; an error cell shows its error.

    python3 tools/dryrun_table.py [DIR]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("16x16", "2x16x16")


def _cell(d: dict | None) -> list[str]:
    if d is None:
        return ["not run"] * 4
    if d.get("status") != "ok":
        return ["error"] * 4
    return [f"{d['per_device_gib']:.3f}", "yes" if d["fits_hbm"] else "no", d["dominant"],
            f"{d['useful_flop_frac']:.4f}"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = Path(argv[0]) if argv else ROOT / "experiments" / "dryrun_torch"
    cells: dict = {}
    for path in sorted(out_dir.glob("*__*__*.json")):
        d = json.loads(path.read_text())
        cells.setdefault((d["arch"], d["shape"]), {})[d["mesh"]] = d
    head = ["arch", "shape", "GiB a rank", "fits HBM", "dominant", "useful FLOP fraction"]
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    errors = {}
    for (arch, shape), by_mesh in sorted(cells.items()):
        cols = zip(*(_cell(by_mesh.get(m)) for m in MESHES))
        print("| " + " | ".join([arch, shape] + [" / ".join(c) for c in cols]) + " |")
        errors.update({(arch, shape, m): d["error"] for m, d in by_mesh.items()
                       if d.get("status") != "ok"})
    for (arch, shape, mesh), err in errors.items():
        print(f"\n{arch} {shape} {mesh}: {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
