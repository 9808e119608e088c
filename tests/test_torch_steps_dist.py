"""The port's step builders on a gloo mesh of 2 x 2 CPU processes,
against the same bundles on a mesh of one and against JAX's unsharded
math.

One arch of each family (dense, MoE, RWKV, hybrid Mamba, encoder-decoder)
at its smoke config with f32 parameters (set on the bundle's model before
its state is placed), B=4 S=16.  For each policy (tp, fsdp_tp, fsdp)
and ``grad_accum`` 1, and ``grad_accum`` 2 under one policy a family
(each policy in some family), two train steps on one batch: the losses,
and AdamW's m, v and f32 master after them.  A prefill and a decode step of
the same weights (the decode at position S-1 over caches filled with
seeded values).  Four processes run the sharded bundles (one torch thread
each); the test process runs the mesh of one and JAX.  The JAX reference
is ``jax.value_and_grad(LM.loss)`` (its microbatches summed in a bf16
accumulator for ``grad_accum`` 2, as the JAX builder sums them), then
``adamw_update`` with the default ``warmup_cosine``, at the bundle's
remat ("full") and a Mamba chunk that divides S (JAX's takes no other).
JAX's own builders fail on jax 0.9.0 before they run (ROADMAP, reference
behaviours), so the port is held against this unsharded math.

Tolerances, and why:

* losses, prefill and decode logits: 1e-5 of the largest |value|
  (f32 sums in other orders: partial products reduced across ranks);
* m and v with ``grad_accum`` 1: 1e-4 of each leaf's largest |value|;
* m and v with ``grad_accum`` 2: 3 bf16 ulps (3 * 2**-7) of each leaf's
  largest |value|, since the microbatch gradients are rounded to bf16
  twice and f32 noise can flip a rounding;
* the master: 6.5e-6 absolute, a little over twice the second step's
  update (lr 3e-4 x warmup 0.01; the first step's warmup scale is 0): a
  gradient entry that is noise in both summation orders takes Adam's
  sign-like update of about that size either way;
* the bf16 caches after the decode step: one bf16 ulp (2**-7) of each
  leaf's largest |value| (the new entry is an f32 value rounded once);
  the f32 states as the logits.
"""
import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, ShapeConfig, get_smoke_config
from repro_torch.convert import flatten_tree, to_numpy_tree, tree_map
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM

B, S = 4, 16
SHAPES.setdefault("dist_train", ShapeConfig("dist_train", S, B, "train"))
SHAPES.setdefault("dist_prefill", ShapeConfig("dist_prefill", S, B, "prefill"))
SHAPES.setdefault("dist_decode", ShapeConfig("dist_decode", S, B, "decode"))

FAMILIES = {"dense": "llama3_8b", "moe": "olmoe_1b_7b", "rwkv": "rwkv6_1b6",
            "hybrid": "jamba_15_large", "encdec": "seamless_m4t_v2"}
POLICIES = ("tp", "fsdp_tp", "fsdp")
# every policy at grad_accum 1 in every family; grad_accum 2 under one
# policy a family, each policy taking it in some family
ACCUM_POLICY = {"dense": "tp", "moe": "fsdp_tp", "rwkv": "fsdp", "hybrid": "tp",
                "encdec": "fsdp_tp"}
CASES = [(policy, 1) for policy in POLICIES] + [("accum", 2)]
_JOIN_S = 600
_LOGIT_REL = 1e-5
_STATE_REL = {1: 1e-4, 2: 3 * 2.0 ** -7}
_MASTER_ATOL = 6.5e-6
# a bf16 cache entry: one bf16 ulp of the leaf's largest |value|, where f32
# noise flips a rounding; the f32 states as the logits
_CACHE_REL = {True: 2.0 ** -7, False: _LOGIT_REL}


def _data(cfg):
    """Seeded batch, decode tokens, caches and memory, as numpy."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    data = {"batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
            "next": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
    if cfg.frontend_tokens:
        front = torch.from_numpy(rng.normal(size=(B, cfg.frontend_tokens, cfg.frontend_dim))
                                 .astype(np.float32)).bfloat16().float().numpy()
        data["batch"]["frontend"] = front
        # bf16 values in f32, the parameters' dtype (torch does not promote
        # a bf16 memory against f32 weights, as JAX does)
        data["memory"] = torch.from_numpy(rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).bfloat16().float()
    meta = LM(cfg, param_dtype=torch.float32, device="meta")
    data["cache"] = tree_map(
        lambda t: torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(np.float32))
        .to(torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32),
        meta.init_cache(B, S, dtype=torch.bfloat16))
    return data


def _bundle_cfg(arch):
    return get_smoke_config(arch)


def _prepare(bundle):
    """The live model's settings: f32 parameters (JAX's builders draw bf16),
    and a Mamba chunk that divides S, as JAX's ``mamba_seq`` needs."""
    bundle.model.param_dtype = torch.float32
    bundle.model.mamba_chunk = S
    return bundle


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def _cases(arch):
    family = next(f for f, a in FAMILIES.items() if a == arch)
    return [(ACCUM_POLICY[family] if p == "accum" else p, ga) for p, ga in CASES]


def _run_all(arch, mesh) -> dict:
    """Every case of ``arch`` on ``mesh``, its results as numpy."""
    cfg = _bundle_cfg(arch)
    data = _data(cfg)
    batch = {k: torch.from_numpy(v) if k != "frontend" else torch.from_numpy(v).bfloat16()
             for k, v in data["batch"].items()}
    out = {}
    for policy, ga in _cases(arch):
        b = _prepare(steps.build_train_step(arch, "dist_train", mesh, cfg=cfg, policy=policy,
                                            grad_accum=ga))
        params, opt = steps.place_state(b, device="cpu")
        db = steps.place_like(batch, b.input_specs["batch"])
        losses = []
        for _ in range(2):
            params, opt, metrics = b.step_fn(params, opt, db)
            losses.append(float(_np(metrics["loss"])))
        out[("train", policy, ga)] = {
            "loss": losses, **{k: flatten_tree(tree_map(_np, opt[k]))
                               for k in ("m", "v", "master")}}
    b = _prepare(steps.build_prefill_step(arch, "dist_prefill", mesh, cfg=cfg))
    params, _ = steps.place_state(b, device="cpu")
    inputs = steps.place_like({k: batch[k] for k in b.input_specs if k != "params"},
                              {k: b.input_specs[k] for k in b.input_specs if k != "params"})
    out["prefill"] = _np(b.step_fn(params, **inputs))
    b = _prepare(steps.build_serve_step(arch, "dist_decode", mesh, cfg=cfg))
    params, _ = steps.place_state(b, device="cpu")
    inputs = {"cache": data["cache"], "tokens": torch.from_numpy(data["next"])}
    if cfg.frontend_tokens:
        inputs["memory"] = data["memory"]
    inputs = steps.place_like(inputs, {k: b.input_specs[k] for k in inputs})
    logits, cache = b.step_fn(params, **inputs)
    out["decode"] = {"logits": _np(logits), "cache": flatten_tree(tree_map(_np, cache))}
    return out


def _worker(rank, world, store_path, out_path, arch):
    """One rank of a mesh of 2 x 2, or (world 1) the mesh of one, whose
    group ``make_local_mesh`` sets up itself."""
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
    try:
        shape = (2, 2) if world > 1 else (1, 1)
        res = _run_all(arch, make_local_mesh(*shape, device="cpu"))
        if rank == 0:
            torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def _start(arch, world, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / f"world{world}.pt"
    procs = [ctx.Process(target=_worker, args=(r, world, str(tmp_path / f"store{world}"),
                                               str(out), arch)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _join(procs, out) -> dict:
    for p in procs:
        p.join(_JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * len(procs), "a rank failed or timed out"
    return torch.load(out, weights_only=False)


def _jax_all(arch) -> dict:
    """JAX's unsharded math on the same weights and data."""
    import jax
    import jax.numpy as jnp

    from repro.models import LM as JaxLM
    from repro.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
    cfg = _bundle_cfg(arch)
    data = _data(cfg)
    tree = to_numpy_tree(LM(cfg, param_dtype=torch.float32, device="cpu"))
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    out = {}
    for ga in (1, 2):
        jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=512, max_seq=S + 8,
                   remat="full", rwkv_chunk=16, mamba_chunk=S)
        grad_fn = jax.jit(jax.value_and_grad(jm.loss))
        params = jax.tree.map(jnp.asarray, tree)
        state = adamw_init(params)
        losses = []
        for _ in range(2):
            if ga == 1:
                loss, grads = grad_fn(params, batch)
            else:
                gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16), params)
                lsum = 0.0
                for i in range(ga):
                    mb = {k: v[i * B // ga:(i + 1) * B // ga] for k, v in batch.items()}
                    lv, g = grad_fn(params, mb)
                    gsum = jax.tree.map(lambda a, b: a + b.astype(a.dtype), gsum, g)
                    lsum = lsum + lv
                grads = jax.tree.map(lambda g: g / ga, gsum)
                loss = lsum / ga
            params, state, _ = adamw_update(AdamWConfig(), params, grads, state,
                                            warmup_cosine(state["step"]))
            losses.append(float(loss))
        out[ga] = {"loss": losses, **{k: flatten_tree(jax.tree.map(np.asarray, state[k]))
                                      for k in ("m", "v", "master")}}
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=512, max_seq=S + 8, mamba_chunk=S)
    params = jax.tree.map(jnp.asarray, tree)
    logits, _ = jm.forward(params, batch["tokens"], batch.get("frontend"), last_only=True)
    out["prefill"] = np.asarray(logits[:, -1])
    cache = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), data["cache"])
    memory = jnp.asarray(data["memory"].numpy()) if cfg.frontend_tokens else None
    logits, cache = jm.decode_step(params, cache, jnp.asarray(data["next"]), S - 1,
                                   memory=memory)
    out["decode"] = {"logits": np.asarray(logits),
                     "cache": flatten_tree(jax.tree.map(
                         lambda t: np.asarray(t.astype(jnp.float32)), cache))}
    return out


@pytest.fixture(scope="module", params=list(FAMILIES), ids=list(FAMILIES))
def runs(request, tmp_path_factory):
    arch = FAMILIES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    cache = _data(_bundle_cfg(arch))["cache"]
    bf16 = {name for name, t in flatten_tree(cache).items() if t.dtype == torch.bfloat16}
    # the 2 x 2 mesh and the mesh of one in processes of their own, JAX here
    sharded, one = _start(arch, 4, tmp), _start(arch, 1, tmp)
    ref = _jax_all(arch)
    return {"sharded": _join(*sharded), "one": _join(*one), "jax": ref, "bf16": bf16,
            "cases": dict(zip(CASES, _cases(arch)))}


def _close_rel(a, b, rel, what):
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _check_train(got, ref, ga):
    _close_rel(got["loss"], ref["loss"], _LOGIT_REL, "loss")
    for k in ("m", "v", "master"):
        assert got[k].keys() == ref[k].keys()
        for name in ref[k]:
            if k == "master":
                np.testing.assert_allclose(got[k][name], ref[k][name], rtol=0,
                                           atol=_MASTER_ATOL, err_msg=name)
            else:
                _close_rel(got[k][name], ref[k][name], _STATE_REL[ga], f"{k} {name}")


@pytest.mark.parametrize("case", CASES, ids=[f"{p}-{ga}" for p, ga in CASES])
def test_train_step_matches_mesh_of_one(runs, case):
    policy, ga = runs["cases"][case]
    _check_train(runs["sharded"][("train", policy, ga)], runs["one"][("train", policy, ga)], ga)


@pytest.mark.parametrize("case", CASES, ids=[f"{p}-{ga}" for p, ga in CASES])
def test_train_step_matches_jax(runs, case):
    policy, ga = runs["cases"][case]
    _check_train(runs["sharded"][("train", policy, ga)], runs["jax"][ga], ga)
    _check_train(runs["one"][("train", policy, ga)], runs["jax"][ga], ga)


@pytest.mark.parametrize("ref", ["one", "jax"])
def test_prefill_step_matches(runs, ref):
    _close_rel(runs["sharded"]["prefill"], runs[ref]["prefill"], _LOGIT_REL, "logits")
    _close_rel(runs["one"]["prefill"], runs["jax"]["prefill"], _LOGIT_REL, "logits")


@pytest.mark.parametrize("ref", ["one", "jax"])
def test_decode_step_matches(runs, ref):
    got, want = runs["sharded"]["decode"], runs[ref]["decode"]
    _close_rel(got["logits"], want["logits"], _LOGIT_REL, "logits")
    assert got["cache"].keys() == want["cache"].keys()
    for name in want["cache"]:
        _close_rel(got["cache"][name], want["cache"][name], _CACHE_REL[name in runs["bf16"]],
                   name)


def test_no_process_group_left_behind(runs):
    assert not dist.is_initialized()
