"""Dry run: every (arch × shape × mesh) cell's step, run on meta tensors
and analysed — port of ``repro/launch/dryrun.py``.

JAX lowers and compiles each cell's jitted step for 512 host devices and
reads XLA's memory and cost analyses.  The port's step is eager, so its
dry run *runs* the step, on the meta device, where nothing is allocated
or computed, under :func:`repro_torch.launch.op_analysis.analyze`:

* the mesh is :func:`~repro_torch.launch.mesh.make_production_mesh`'s
  (16, 16) or (2, 16, 16) over a fake process group of 256 or 512 ranks
  (the ``fake`` backend over a ``FakeStore``; no rank exists and no
  collective moves data), which :func:`run_cell` sets up where no default
  group exists and destroys when it is done;
* the bundle is built on the meta device and its model's parameters are
  the bundle's input specs (meta DTensors), so every count is rank 0's
  share: its shards, its collectives, the kernels it launches (the
  kernels' meta branches record their work in
  :mod:`repro_torch.kernels.cost`);
* the result holds JAX's keys where they mean the same thing: the bytes
  each rank holds at its peak against the card's memory, its FLOPs and
  HBM bytes, its collective traffic, and the roofline terms over the
  H100 SXM spec rates of :mod:`repro_torch.kernels.cost`.

What JAX has and the port does not: ``lower_s``/``compile_s`` (one
``trace_s`` here), XLA:CPU's corrections (``memory_s_raw``,
``per_device_gib_tpu_est``, ``fits_hbm_raw``: the port's dtypes are the
real ones), the while-loop counts (an eager step dispatches every
iteration) and ``_write_hlo`` (there is no HLO to keep).

Cells are written as JSON under ``experiments/dryrun_torch/``; an error
becomes an error cell with its traceback.

Usage::

    python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--force]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist
from torch import nn

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import flatten_tree, param_tree
from repro_torch.kernels.cost import HBM_BYTES, LINK_BYTES, PEAK_BYTES, PEAK_FLOPS

from .mesh import make_production_mesh
from .op_analysis import analyze
from .steps import build_prefill_step, build_serve_step, build_train_step

__all__ = ["cells", "build", "run_cell", "run_production", "cell_path", "main",
           "LONG_OK_FAMILIES", "OUT_DIR"]

# explicit name: under ``python -m`` this module runs as __main__
_log = logging.getLogger("repro_torch.launch.dryrun")

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# long_500k needs sub-quadratic attention: run only for SSM/hybrid.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def cells(include_long: bool = True):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k":
                if not include_long or cfg.family not in LONG_OK_FAMILIES:
                    continue
            yield arch, shape.name


def build(arch: str, shape_name: str, mesh, **kw):
    kind = SHAPES[shape_name].kind
    if kind == "train":
        kw.pop("kv_dtype", None)   # decode-only knob
        return build_train_step(arch, shape_name, mesh, **kw)
    kw.pop("moment_dtype", None)   # train-only knobs
    kw.pop("rwkv_chunk", None)
    kw.pop("grad_accum", None)
    kw.pop("remat", None)
    if kind == "prefill":
        kw.pop("kv_dtype", None)   # decode-only knob
        return build_prefill_step(arch, shape_name, mesh, **kw)
    return build_serve_step(arch, shape_name, mesh, **kw)


_REPO_ROOT = str(Path(__file__).resolve().parents[3])


def _sanitize_traceback(tb: str) -> str:
    """Relativize repo paths so committed artifacts stay machine-neutral."""
    return tb.replace(_REPO_ROOT + os.sep, "")


def _spec_args(bundle):
    s = bundle.input_specs
    if "batch" in s:                       # train
        return (s["params"], s["opt_state"], s["batch"])
    if "cache" in s:                       # decode
        args = [s["params"], s["cache"], s["tokens"]]
        if "memory" in s:
            args.append(s["memory"])
        return tuple(args)
    args = [s["params"], s["tokens"]]      # prefill
    if "frontend" in s:
        args.append(s["frontend"])
    return tuple(args)


def _bind_specs(bundle) -> None:
    """Make the meta model's parameters the bundle's parameter specs, so
    the step reads the arguments it is given (as JAX's step reads its
    ``params``); ``input_specs["params"]`` becomes the model's tree."""
    model = bundle.model
    specs = flatten_tree(bundle.input_specs["params"])
    train = "opt_state" in bundle.input_specs
    for prefix, mod in list(model.named_modules()):
        for name in list(mod._parameters):
            spec = specs[f"{prefix}.{name}" if prefix else name]
            mod._parameters[name] = nn.Parameter(spec, requires_grad=train)
    bundle.input_specs["params"] = param_tree(model)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _fake_group(world: int) -> bool:
    """Set up a fake default group of ``world`` ranks where none exists;
    whether this call set it up."""
    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def model_flops(cfg, shape) -> float:
    """JAX's model FLOPs of a step: 6 N_active a token to train, 2 to serve."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_active * shape.global_batch * shape.seq_len
    return 2 * n_active * shape.global_batch


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, verbose: bool = True, mesh=None) -> dict:
    """Build the cell's bundle and run its step on meta tensors under the
    analysis; the cell's result dict.

    ``mesh`` defaults to the production mesh over a fake group of 256 (512
    with ``multi_pod``) ranks, set up here where no default group exists
    and destroyed at the end; a default group of another size raises
    (naming both).  A caller may pass a mesh of its own (a mesh of one)."""
    owned = False
    if mesh is None:
        owned = _fake_group(512 if multi_pod else 256)
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        return _run(arch, shape_name, mesh, overrides or {}, verbose)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(arch, shape_name, mesh, overrides, verbose) -> dict:
    n_chips = mesh.size()
    t0 = time.perf_counter()
    bundle = build(arch, shape_name, mesh, **dict(overrides))
    _bind_specs(bundle)
    _, st = analyze(bundle.step_fn, *_spec_args(bundle))
    t_trace = time.perf_counter() - t0
    coll = st.collectives

    flops = float(st.flops)
    bytes_accessed = float(st.bytes_accessed)
    compute_s = sum(f / PEAK_FLOPS[rate] for rate, f in st.flops_by_rate.items())
    memory_s = bytes_accessed / PEAK_BYTES
    collective_s = coll.wire_bytes / LINK_BYTES
    per_dev_bytes = st.peak_bytes
    cfg = bundle.model.cfg
    shape = SHAPES[shape_name]
    mflops = model_flops(cfg, shape)
    slowest = max(compute_s, memory_s, collective_s)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(mesh),
        "n_chips": n_chips,
        "policy": bundle.policy,
        "status": "ok",
        "trace_s": round(t_trace, 2),
        "per_device_bytes": int(per_dev_bytes),
        "per_device_gib": round(per_dev_bytes / 2**30, 3),
        "argument_bytes": int(st.argument_bytes),
        "argument_gib": round(st.argument_bytes / 2**30, 3),
        "temp_gib": round((per_dev_bytes - st.argument_bytes) / 2**30, 3),
        "fits_hbm": bool(per_dev_bytes <= HBM_BYTES),
        "flops_per_device": flops,
        "flops_by_rate": st.flops_by_rate,
        "bytes_per_device": bytes_accessed,
        "n_ops": st.n_ops,
        "kernel_launches": st.launches,
        "collective_bytes_per_device": coll.total_bytes,
        "collective_wire_bytes": coll.wire_bytes,
        "collectives": {k: [coll.count_by_type[k], v]
                        for k, v in coll.bytes_by_type.items()},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_total": mflops,
        "model_flops_per_device": mflops / n_chips,
        "useful_flop_frac": (mflops / n_chips) / flops if flops else 0.0,
        "roofline_frac": ((mflops / n_chips / PEAK_FLOPS["bf16"]) / slowest
                          if slowest > 0 else 0.0),
    }
    if verbose:
        _log.info("%s", json.dumps(
            {k: result[k] for k in (
                "arch", "shape", "mesh", "policy", "trace_s", "per_device_gib",
                "fits_hbm", "compute_s", "memory_s", "collective_s", "dominant",
                "useful_flop_frac", "roofline_frac")}, indent=None))
    return result


def _cached_ok(path: Path) -> bool:
    """True iff the cached cell JSON records a successful run.

    Error cells (and unreadable files) are treated as stale so a fixed
    environment regenerates them without needing ``--force``.
    """
    try:
        return json.loads(path.read_text()).get("status") == "ok"
    except (OSError, ValueError):
        return False


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> Path:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"_{tag}" if tag else ""
    return OUT_DIR / f"{arch}__{shape}__{mesh}{suffix}.json"


def run_production(arch: str, shape_name: str) -> int:
    """The ``--production`` flag of ``launch/train.py`` and ``launch/serve.py``:
    the full-size cell on the single-pod production mesh, written to its
    :func:`cell_path`; 0 exactly when its status is ``"ok"``."""
    result = run_cell(arch, shape_name, multi_pod=False)
    path = cell_path(arch, shape_name, False)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2))
    _log.info("cell: %s", path)
    return 0 if result["status"] == "ok" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for experiment JSONs")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--rwkv-chunk", type=int, default=None)
    ap.add_argument("--moment-dtype", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)
    if not logging.getLogger().handlers:     # CLI: bare messages on stdout
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stdout)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        todo = list(cells())
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = [args.shape] if args.shape else [
            s for a, s in cells() if a == args.arch]
        todo = [(args.arch, s) for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    overrides = {}
    for key in ("attn_chunk", "rwkv_chunk", "moment_dtype", "grad_accum", "kv_dtype",
                "policy", "remat"):
        if getattr(args, key):
            overrides[key] = getattr(args, key)

    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            path = cell_path(arch, shape, mp, args.tag)
            if path.exists() and not args.force:
                if _cached_ok(path):
                    _log.info("cached: %s", path.name)
                    continue
                _log.info("stale error cell, re-running: %s", path.name)
            try:
                result = run_cell(arch, shape, multi_pod=mp, overrides=overrides or None)
            except Exception as e:  # noqa: BLE001 - record and continue
                failures += 1
                result = {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": "error", "error": repr(e),
                    "traceback": _sanitize_traceback(
                        traceback.format_exc())[-2000:],
                }
                _log.error("FAIL %s %s mp=%s: %r", arch, shape, mp, e)
            path.write_text(json.dumps(result, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
