"""The port's GPipe runner (``repro_torch.runtime.pipeline``) on four gloo
CPU processes, against JAX's sequential math.

The stages of ``tests/test_pipeline.py``: D=16, B=8, S=4 stages of
``tanh(x @ w + b)``, drawn from seed 0.  JAX's own pipeline test fails on
jax 0.9.0 (ROADMAP, reference behaviours), so the port is held against
the sequential reference this process computes with JAX: the forward
(µ=4), the gradients of ``mean(y**2)`` against ``jax.grad(loss_seq)``,
and the forward at µ=8 (fill and drain with more microbatches than
stages).  Four processes (one per stage, a ``FileStore`` under
``tmp_path``, one torch thread each, no ``jax``) run the pipeline; each
has its own time limit, so a hang fails the test.  Tolerances are JAX's:
1e-5/1e-5 for the outputs, 1e-5/1e-4 for the gradients.
"""
import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.runtime import pipeline_apply, stack_stage_params

D, B, N_STAGES = 16, 8, 4
_JOIN_S = 120


def _stages():
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32),
               "b": (rng.normal(size=(D,)) * 0.1).astype(np.float32)}
              for _ in range(N_STAGES)]
    x = rng.normal(size=(B, D)).astype(np.float32)
    return stages, x


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _worker(rank, store_path, out_dir):
    """One stage: the forward at µ=4 with its gradients, and at µ=8."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_STAGES), rank=rank,
                            world_size=N_STAGES)
    try:
        mesh = init_device_mesh("cpu", (N_STAGES,), mesh_dim_names=("stage",))
        stages, x = _stages()
        full = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                   for s in stages])
        params = {k: DTensor.from_local(v[rank:rank + 1].clone(), mesh, [Shard(0)],
                                        run_check=False).requires_grad_()
                  for k, v in full.items()}
        xt = torch.from_numpy(x)
        y = pipeline_apply(_stage_fn, params, xt, mesh=mesh, microbatches=4)
        (y ** 2).mean().backward()
        with torch.no_grad():
            y8 = pipeline_apply(_stage_fn, params, xt, mesh=mesh, microbatches=8)
        torch.save({"y": y.detach().numpy(), "y8": y8.numpy(),
                    "grads": {k: p.grad.to_local()[0].numpy() for k, p in params.items()}},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_reference():
    import jax
    import jax.numpy as jnp
    stages, x = _stages()
    stages = [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]

    def seq(stages, x):
        y = x
        for st in stages:
            y = jnp.tanh(y @ st["w"] + st["b"])
        return y
    g = jax.grad(lambda st, x: (seq(st, x) ** 2).mean())(stages, jnp.asarray(x))
    return np.asarray(seq(stages, jnp.asarray(x))), [
        {k: np.asarray(v) for k, v in s.items()} for s in g]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(N_STAGES)]
    for p in procs:
        p.start()
    ref = _jax_reference()
    for p in procs:
        p.join(_JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * N_STAGES, "a stage failed or timed out"
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(N_STAGES)]
    return got, ref


def test_forward_matches_sequential(runs):
    got, (ref, _) = runs
    for rank in got:
        np.testing.assert_allclose(rank["y"], ref, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax_grad(runs):
    got, (_, grads) = runs
    for s, rank in enumerate(got):
        for k in ("w", "b"):
            np.testing.assert_allclose(rank["grads"][k], grads[s][k], atol=1e-5, rtol=1e-4)


def test_more_microbatches_than_stages(runs):
    got, (ref, _) = runs
    for rank in got:
        np.testing.assert_allclose(rank["y8"], ref, atol=1e-5, rtol=1e-5)


def test_batch_must_divide_into_microbatches():
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=N_STAGES)
    try:
        mesh = init_device_mesh("cpu", (N_STAGES,), mesh_dim_names=("stage",))
        params = {"w": torch.zeros(N_STAGES, D, D), "b": torch.zeros(N_STAGES, D)}
        with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
            pipeline_apply(_stage_fn, params, torch.zeros(6, D), mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_stack_stage_params():
    per = [{"w": torch.full((2, 3), float(i)), "inner": {"b": torch.full((3,), -float(i))}}
           for i in range(3)]
    st = stack_stage_params(per)
    assert st["w"].shape == (3, 2, 3) and st["inner"]["b"].shape == (3, 3)
    for i in range(3):
        assert torch.equal(st["w"][i], per[i]["w"])
        assert torch.equal(st["inner"]["b"][i], per[i]["inner"]["b"])
