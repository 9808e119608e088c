"""Pipeline parallelism end-to-end on the PyTorch port: the paper's
scheduler decides the stage split; the port's GPipe runner
(``repro_torch.runtime.pipeline``) executes it.  The counterpart of
``examples/pipeline_training.py``: an 8-layer tanh MLP "model" trained a
few steps, with the gradients flowing back through the pipeline.

One process is one stage.  With ``--device cpu`` it runs 4 stages as gloo
processes; on the cards (the default) one stage per visible card over
NCCL, which puts no two ranks on one card, so one card runs one stage.

Run:  PYTHONPATH=src python examples/pipeline_training_torch.py [--device cpu]
"""
import argparse
import multiprocessing
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import Platform, Processor, Workflow, schedule
from repro_torch.runtime import pipeline_apply, stack_stage_params

N_LAYERS, D, BATCH, MICROBATCHES, LR = 8, 32, 16, 4, 0.1
CPU_STAGES = 4
JOIN_S = 300


def plan_stages(n_layers: int, n_stages: int) -> list[list[int]]:
    """Let the scheduler split a layer chain into pipeline stages."""
    wf = Workflow(name="mlp-chain")
    prev = None
    for i in range(n_layers):
        t = wf.add_task(work=1.0, mem=0.1, persistent=1.0,
                        label=f"layer{i}")
        if prev is not None:
            wf.add_edge(prev, t, 0.5)
        prev = t
    # memory: n_layers / n_stages layers of weights (1.0 each) + transient activations
    plat = Platform([Processor(f"d{i}", 1.0, n_layers / n_stages + 1.5)
                     for i in range(n_stages)], bandwidth=10.0)
    report = schedule(wf, plat, kprime=[n_stages])
    assert report.feasible, report.infeasibility
    res = report.best
    stages = [sorted(m) for m in res.quotient.members.values()]
    stages.sort(key=min)
    print(f"scheduler split {n_layers} layers into "
          f"{[len(s) for s in stages]} per stage "
          f"(makespan {res.makespan:.2f})")
    return stages


def _stage_fn(p, x):
    for w in p["w"]:
        x = torch.tanh(x @ w)
    return x


def _worker(rank: int, n_stages: int, layers_per_stage: int, device: str, store_path: str,
            steps: int) -> None:
    """One stage: its rows of the stacked weights, the pipelined training steps."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store_path, n_stages), rank=rank,
                            world_size=n_stages)
    try:
        mesh = init_device_mesh(device, (n_stages,), mesh_dim_names=("stage",))
        # every rank draws every stage's weights from one seed and keeps its row
        rng = np.random.default_rng(0)
        stacked = stack_stage_params([
            {"w": torch.from_numpy((rng.normal(size=(layers_per_stage, D, D))
                                    / np.sqrt(D)).astype(np.float32))}
            for _ in range(n_stages)])
        params = {k: DTensor.from_local(v[rank:rank + 1].to(device), mesh, [Shard(0)],
                                        run_check=False).requires_grad_()
                  for k, v in stacked.items()}
        x = torch.from_numpy(rng.normal(size=(BATCH, D)).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.normal(size=(BATCH, D)).astype(np.float32)).to(device)
        losses = []
        for _ in range(steps):
            out = pipeline_apply(_stage_fn, params, x, mesh=mesh, microbatches=MICROBATCHES)
            loss = ((out - y) ** 2).mean()
            loss.backward()
            with torch.no_grad():
                for p in params.values():
                    p -= LR * p.grad
                    p.grad = None
            losses.append(float(loss.detach()))
        if rank == 0:
            print(f"pipeline training ({n_stages} stage(s), {MICROBATCHES} microbatches, "
                  f"{device}): loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        assert losses[-1] < losses[0], losses
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        n_stages = CPU_STAGES
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card visible; pass --device cpu to run the stages "
                             "as CPU processes")
        n_stages = torch.cuda.device_count()
        if n_stages == 1:
            print("one card visible: one stage (NCCL puts no two ranks on one card; "
                  "each further card adds a stage)")
    stages = plan_stages(N_LAYERS, n_stages)
    assert len(stages) == n_stages and len({len(s) for s in stages}) == 1, stages

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker, args=(
            r, n_stages, len(stages[0]), args.device, os.path.join(tmp, "store"), args.steps))
            for r in range(n_stages)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n_stages, f"a stage failed or timed out: exit codes {codes}"


if __name__ == "__main__":
    main()
