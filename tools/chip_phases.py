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
reads), ``production_dryrun``, ``pipeline``, and the sliding window's:
``kernel_window`` and ``backward_window`` (phases 2 and 8's windowed
rows), ``mixtral`` (phase 15 with its 32k prefill), ``mixtral_window``
(its f32 check and training step), ``train_lm_example`` (phase 28a);
``scheduler`` (phase 29, after the prefill of phases 4 and 12 on full
llama3_8b and olmoe_1b_7b, whose rows it reads); ``sim`` (phases 4, 12, 29
and then 30: the replays of phase 29's schedules, the replans after a lost
card beside phase 4's measured prefill, the elastic example on the card);
``throughput`` (phases 4, 12, 29, 30 and then 31: the throughput planner
on the seven families and the port's models on four cards, ``run_sustained``
cold then seeded, the service at the paper's size, the host-only examples);
and ``flash_ab``, which times the tensor-core flash kernels of other
versions of ``csrc/flash_attention.cu`` against the current one (below).
``--vision-cut LAYERS PERIOD`` trains vision at another depth and
``cross_attn_period`` than ``chip_smoke.VISION_TRAIN_CUT``.  The step
phases take the Trainer's step time they are set beside as
``--trainer-step-s`` (the ratio is reported, not checked).

``flash_ab`` builds each ``--ab-source NAME=PATH`` with the kernels' own
nvcc flags and times its tensor-core forward and backward beside the
current source's, on the same seeded bf16 inputs with no window
(``AB_SHAPES``), in turns (the versions in order, then back), each with
``chip_smoke.time_ms``; it reports whether each version's outputs and
gradients have the bits of the first.  Calls go through the C entry
points, so no launch count moves; the int arguments each version's entry
points take are read from its source.  To set the parent commit beside
the tree:

    git show HEAD~1:src/repro_torch/kernels/csrc/flash_attention.cu > build/parent.cu
    python3 tools/chip_phases.py flash_ab --ab-source parent=build/parent.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

PHASES = ("steps_prefill", "steps_decode", "steps_train", "steps_rwkv_train",
          "jamba_train", "vision_train", "dryrun_steps", "production_dryrun", "pipeline",
          "kernel_window", "backward_window", "mixtral", "mixtral_window", "train_lm_example",
          "scheduler", "sim", "throughput", "flash_ab")
# flash_ab's (b, s, hq, hkv, hd, causal): llama3_8b's, olmoe_1b_7b's and
# seamless_m4t_v2's layers at their training length
AB_SHAPES = [(1, 4096, 32, 8, 128, True), (1, 4096, 16, 16, 128, True),
             (1, 4096, 16, 16, 64, True), (1, 4096, 16, 16, 64, False)]
AB_ENTRIES = {"fwd": ("repro_flash_attention_fwd_wgmma", 5),
              "bwd": ("repro_flash_attention_bwd_wgmma", 9)}


def entry_ints(src: Path) -> int:
    """The int arguments the tensor-core entry points of ``src`` take, read
    from their signatures (6 before the sliding window, 7 with it)."""
    text = src.read_text()
    counts = set()
    for entry, _ in AB_ENTRIES.values():
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        if m is None:
            raise ValueError(f"{src} defines no {entry}")
        counts.add(sum(re.fullmatch(r"int\s+\w+", a.strip()) is not None
                       for a in m.group(1).split(",")))
    if len(counts) != 1:
        raise ValueError(f"the entry points of {src} take {sorted(counts)} ints")
    return counts.pop()


def ab_load(lib_path: Path, n_int: int) -> dict:
    lib = ctypes.CDLL(str(lib_path))
    fns = {"n_int": n_int}
    for kind, (entry, n_ptr) in AB_ENTRIES.items():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[kind] = fn
    return fns


def ab_calls(lib: dict, shape) -> dict:
    """Forward and backward launches of one version on seeded bf16 inputs,
    each run once; their outputs under "out"."""
    b, s, hq, hkv, hd, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device="cuda").bfloat16()
                   for n in (hq, hkv, hkv, hq))
    o = torch.empty_like(q)
    lse = torch.empty((b * hq, s), dtype=torch.float32, device="cuda")
    rowstat = torch.empty((b * hq, -(-s // 128) * 128, 2), dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    ints = [b * hq, b * hkv, s, hd, 1, int(causal), 0][:lib["n_int"]]
    ptrs = {"fwd": (q, k, v, o, lse), "bwd": (q, k, v, do, lse, rowstat, dq, dk, dv)}

    def launcher(kind):
        args = [t.data_ptr() for t in ptrs[kind]]

        def launch():
            err = lib[kind](*args, *ints, hd ** -0.5, stream)
            if err:
                raise RuntimeError(f"{kind} launch failed: cudaError_t {err}")
        return launch
    made = {kind: launcher(kind) for kind in AB_ENTRIES}
    made["fwd"]()
    made["bwd"]()
    made["out"] = (o, lse, dq, dk, dv)
    return made


def flash_ab(sources: list[str], reps: int = 20) -> list[dict]:
    """The ``flash_ab`` phase: every ``NAME=PATH`` of ``sources``, then the
    current source, timed in turns at ``AB_SHAPES``."""
    libs = {}
    for spec in sources:
        name, path = spec.split("=", 1)
        out = cs._build.BUILD_DIR / f"ab_{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cs._build.nvcc_path(), *cs._build.NVCC_FLAGS, "-o", str(out), path],
                       check=True, stdout=subprocess.DEVNULL)
        libs[name] = ab_load(out, entry_ints(Path(path)))
    libs["current"] = ab_load(cs._build.library_path("flash_attention"),
                              entry_ints(cs._build.CSRC / "flash_attention.cu"))
    names, rows = list(libs), []
    for shape in AB_SHAPES:
        made = {name: ab_calls(lib, shape) for name, lib in libs.items()}
        torch.cuda.synchronize()
        row = {"shape": list(shape), f"same_bits_as_{names[0]}": {
            name: all(torch.equal(a, b) for a, b in zip(made[names[0]]["out"], m["out"]))
            for name, m in made.items()}}
        for kind in AB_ENTRIES:
            turns = [(name, cs.time_ms(made[name][kind], reps)) for name in names + names[::-1]]
            row[kind] = {name: [t for n, t in turns if n == name] for name in names}
            row[f"{kind}_over_{names[0]}"] = {
                name: sum(row[kind][name]) / sum(row[kind][names[0]]) for name in names}
        cs.emit("flash_ab", **row)
        rows.append(row)
        del made
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--vision-cut", nargs=2, type=int, metavar=("LAYERS", "PERIOD"))
    ap.add_argument("--trainer-step-s", type=float, default=float("nan"))
    ap.add_argument("--ab-source", action="append", default=[], metavar="NAME=PATH",
                    help="another version of csrc/flash_attention.cu for flash_ab")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return len(args.phases)
    if args.vision_cut:
        cs.VISION_TRAIN_CUT = dict(n_layers=args.vision_cut[0],
                                   cross_attn_period=args.vision_cut[1])
    smi = cs.phase_env()
    print(smi, flush=True)
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

    def scheduler():
        rows = {}
        for arch in ("llama3_8b", "olmoe_1b_7b"):
            model = cs.LM(cs.get_config(arch), seed=cs.SEED, device="cuda")
            rows[arch] = cs.phase_prefill(model)
            del model
            cs.free()
        return rows, cs.phase_scheduler(smi, rows)

    def sim():
        rows, sched = scheduler()
        cs.phase_sim(smi, sched, rows["llama3_8b"])
        return rows

    def throughput():
        rows = sim()
        cs.phase_throughput(smi, rows["llama3_8b"])
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
            "pipeline": lambda: cs.phase_pipeline(llama),
            "kernel_window": cs.phase_kernel_window,
            "backward_window": cs.phase_backward_window,
            "mixtral": lambda: cs.phase_mixtral(cs.get_config("mixtral_8x7b")),
            "mixtral_window": lambda: cs.phase_mixtral_window(cs.get_config("mixtral_8x7b")),
            "train_lm_example": cs.phase_train_lm_example,
            "scheduler": scheduler,
            "sim": sim,
            "throughput": throughput,
            "flash_ab": lambda: flash_ab(args.ab_source)}
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
