"""Quickstart on the PyTorch port: the paper's scheduler + the port in a
minute.  The counterpart of ``examples/quickstart.py``.

1. Map a memory-constrained workflow through the port's unified Scheduler
   API (``repro_torch.core``, host code in numpy): the baseline
   (DagHetMem) and the four-step heuristic (DagHetPart).
2. Lower mixtral_8x7b's ``decode_32k`` cell to a workflow DAG and let the
   same scheduler place it on a fleet of H100 cards (the
   ``h100_fleet_si`` preset: spec rates, a few degraded cards).
3. Train a small LM for a few steps through the port's fault-tolerant
   runtime, on the card by default (``--device cpu``: on the CPU).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs import get_config, get_smoke_config, shape_by_name
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import (
    Scheduler,
    SchedulerConfig,
    default_cluster,
    generate_workflow,
    h100_fleet_si,
    schedule,
    validate_mapping,
)
from repro_torch.core.autoshard import plan
from repro_torch.runtime import Trainer, TrainerConfig


def part1_paper_core():
    print("=== 1. DAGP-PM: baseline vs four-step heuristic ===")
    plat = default_cluster()
    wf = generate_workflow("blast", 400, seed=1, platform=plat)
    # one facade for both algorithms; reports are never None
    base = schedule(wf, plat, algorithm="dag_het_mem")
    het = Scheduler(SchedulerConfig(
        algorithm="dag_het_part", kprime=[1, 4, 9, 19, 36], workers=2,
    )).schedule(wf, plat)
    assert base.feasible and het.feasible
    assert validate_mapping(wf, base.best) == []
    assert validate_mapping(wf, het.best) == []
    print(f"workflow: blast, {wf.n} tasks on {plat.k} heterogeneous procs")
    print(f"DagHetMem  makespan: {base.makespan:10.1f}  "
          f"(blocks: {base.summary.k_used})")
    print(f"DagHetPart makespan: {het.makespan:10.1f}  "
          f"(blocks: {het.summary.k_used})")
    trace = ", ".join(
        f"k'={p.k_prime}:" + (f"{p.makespan:.0f}" if p.feasible else "inf")
        for p in het.sweep)
    print(f"sweep trace ({het.workers} workers): {trace}")
    slowest = max(het.stage_times, key=het.stage_times.get)
    print(f"stage timings: hottest stage '{slowest}' "
          f"({het.stage_times[slowest]:.2f}s of {het.total_time_s:.2f}s)")
    print(f"improvement: {base.makespan / het.makespan:.2f}x "
          f"(paper: 2.44x average)\n")


def part2_model_placement():
    print("=== 2. The scheduler as the placement layer, on an H100 fleet ===")
    cfg = get_config("mixtral_8x7b")
    fleet = h100_fleet_si({"h100": 56, "h100-degraded": 8})
    p = plan(cfg, shape_by_name("decode_32k"), fleet, kprime=[8, 16, 32, 64])
    print(f"mixtral-8x7b decode_32k on {fleet.k} H100 cards (8 degraded; spec rates):")
    print(f"  stages: {p.n_stages}, valid: {p.valid}")
    print(f"  est step latency: {p.est_step_s * 1e3:.2f} ms (the spec roofline's, not measured)")
    best_kp = p.report.summary.k_prime
    print(f"  k' sweep: {len(p.report.sweep)} attempts, best at k'={best_kp}")
    spread = len(set(p.expert_placement.values()))
    print(f"  expert placement spread: {spread} stages "
          f"(emergent expert parallelism)\n")
    assert p.valid


def part3_training(device: str):
    print(f"=== 3. Fault-tolerant training on a reduced config ({device}) ===")
    cfg = get_smoke_config("llama3_8b")
    shape = ShapeConfig("quickstart", seq_len=16, global_batch=4, kind="train")
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(cfg, shape,
                          TrainerConfig(steps=8, ckpt_every=4, ckpt_dir=d),
                          attn_chunk=8, device=device)
        hist = trainer.run()
    print(f"8 steps: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")
    print("done.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    part1_paper_core()
    part2_model_placement()
    part3_training(args.device)


if __name__ == "__main__":
    main()
