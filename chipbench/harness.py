"""The benchmark's general part: the manifest, a cell's context, the
readers of the metrics, the limits, the check that JAX stayed out, and
the result line.

Everything that belongs to one configuration, traffic mix or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``kind`` names the driver ``drivers/<kind>.py``), ``metrics/<metric>.py``
(a ``read(record)`` that returns a number or None) and
``limits/<workload>.json`` (the limit of each number that decides
``correct``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["HERE", "ROOT", "Ctx", "set_env", "load_manifest", "make_ctx", "metrics_for",
           "read_metric", "foreign_modules", "judge", "result_line", "run_cell"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_env(root: Path = ROOT) -> None:
    """Before torch is imported: put the program's import path first and
    keep every cache a library may open inside the checkout (the port
    builds its kernels under ``build/`` itself).  The training cell's
    AdamW takes 4 GiB temporaries beside 60 GB of state, which the
    caching allocator fragments without expandable segments."""
    import os
    cache = root / "build" / "chipbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    for path in (str(root / "src"), str(root)):
        if path not in sys.path:
            sys.path.insert(0, path)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Ctx:
    """One run of one cell.  ``hooks`` maps a timed entry ("prefill",
    "step") to a function that wraps it, for the tests that plant faults
    underneath a run; and "planted" to faults by name, each a wrapper of
    the prefill whose answers to the judged requests are read beside the
    program's after the window (``calibrate.py``)."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    hooks: dict = field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    def peak_bytes(self) -> int:
        if not self.on_card:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    def mark(self) -> float:
        """The host clock once the device has finished what it was given."""
        if self.on_card:
            import torch
            torch.cuda.synchronize()
        return time.perf_counter()

    def split(self, phases: list) -> dict:
        """Set-up's phases in seconds, from ``phases`` (name, :meth:`mark`
        at the phase's end)."""
        out, last = {}, self.t_start
        for name, t in phases:
            out[name] = t - last
            last = t
        return out

    def free(self) -> None:
        """Return what the program held to the device."""
        import gc
        gc.collect()
        if self.on_card:
            import torch
            torch.cuda.empty_cache()


def make_ctx(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             manifest: dict | None = None, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None, t_start: float | None = None) -> Ctx:
    """The context of ``workload`` from its files; the overrides shrink a
    cell for the CPU tests."""
    manifest = manifest or load_manifest()
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = _load_json(HERE / "configs" / f"{cell['config']}.json")
    if config_overrides:
        config = {**config, "model": {**config["model"], **config_overrides}}
    traffic = {**_load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
               **(traffic_overrides or {})}
    limits = _load_json(HERE / "limits" / f"{workload}.json")
    return Ctx(workload, config, traffic, limits, int(seed), float(seconds), bool(trace),
               device=device, t_start=time.perf_counter() if t_start is None else t_start)


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports."""
    specs = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [s for s in specs if "workloads" not in s or workload in s["workloads"]]


def read_metric(name: str, record: dict):
    """``metrics/<name>.py``'s reading of ``record`` (None: nothing to read)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, limit in limits["numbers"].items():
        value = numbers.get(name)
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(ctx: Ctx, manifest: dict, record: dict) -> dict:
    """The result's JSON object; the compared numbers come last."""
    ok, checks = judge(record["numbers"], ctx.limits)
    correct = ok and record["attempted"] > 0 and record["failed"] == 0
    metrics = {}
    for spec in metrics_for(manifest, ctx.workload, ctx.trace):
        value = read_metric(spec["name"], record)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu" if ctx.on_card else "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    if ctx.on_card:
        import torch
        device["kind"] = torch.cuda.get_device_name(0)
        device["power_limit_w"] = _power_limit_w()
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device}
    tr = record.get("trace")
    if tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["setup_split"] = record.get("setup_split")
    out["reference_s"] = record.get("reference_s")
    out["checks"] = checks
    return out


def run_cell(ctx: Ctx, manifest: dict | None = None) -> dict:
    """Drive the cell's traffic, check it, and return the result object."""
    manifest = manifest or load_manifest()
    driver = importlib.import_module(f"chipbench.drivers.{ctx.traffic['kind']}")
    record = driver.run(ctx)
    return result_line(ctx, manifest, record)
