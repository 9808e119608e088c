"""Port parity: AdamW and the learning-rate schedules against
``repro.optim``.

Trees of nested dicts and lists, inputs drawn with numpy and handed to
both.  Both sides do the same f32 operations in the same order per
element, and the global norm sums the leaves in the same (sorted-key)
order but each leaf's squares in another order, so the norm agrees to
1e-6 relative and every f32 state entry to rtol 1e-5, atol 1e-7.  bf16
params: each new param is its f32 master rounded once to bf16 on both
sides, so they agree to one bf16 ulp (2**-8 of the value, with the master
held to the f32 limit); bf16 grads are multiplied by the clip scale
rounded to bf16 on both sides.  (On these inputs both updates are in
fact equal bit for bit.)

CPU and meta leaves (DTensors too) take the eager path, here held to
JAX over three steps, and the ``optim.*`` counters to the elements
updated.  The card's path (``tests/test_torch_kernels_cuda.py`` holds its
kernels to the eager path) is wired here with CPU stand-ins of the two
kernels: strided leaves through contiguous copies, the refusals, and the
norm of DTensor leaves on a gloo mesh of two processes, each leaf's sum
of squares reduced over the mesh dims it is sharded on.
"""
import multiprocessing
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.profiler import ProfilerActivity, profile

from repro import optim as jopt
from repro_torch.convert import flatten_tree, tree_leaves, tree_map
from repro_torch.kernels import adamw as fused
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.obs import METRICS
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, adamw_update_eager,
                               constant, global_norm, warmup_cosine)
from repro_torch.optim import adamw as adamw_mod

_F32 = dict(rtol=1e-5, atol=1e-7)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree(seed, scale=1.0):
    """A nested dict/list tree of f32 numpy leaves, keys out of sorted order."""
    rng = np.random.default_rng(seed)
    draw = lambda *shp: (scale * rng.normal(size=shp)).astype(np.float32)  # noqa: E731
    return {"w": draw(6, 5), "emb": draw(7, 3),
            "blocks": [{"b": draw(3, 2), "a": draw(4)} for _ in range(2)]}


def _torch_tree(tree, dtype):
    return tree_map(lambda a: torch.tensor(a).to(dtype), tree)


def _jax_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _flat(tree) -> dict:
    """Leaves by dotted path as f32 numpy (bf16 widened exactly)."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype.name == "bfloat16" else x
    return {k: arr(v) for k, v in flatten_tree(tree).items()}


def _no_kernel(monkeypatch):
    """Make any launch of the fused kernels fail the test."""
    def refuse(*a, **k):
        raise AssertionError("the fused AdamW kernels ran on leaves they do not take")
    monkeypatch.setattr(fused, "grad_sumsq", refuse)
    monkeypatch.setattr(fused, "update", refuse)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (1e-3, False)])
def test_one_adamw_update_matches_jax(monkeypatch, param_dtype, grad_scale, clipped):
    _no_kernel(monkeypatch)
    params, grads = _tree(0), _tree(1, grad_scale)
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jdt = jnp.dtype(param_dtype)
    jparams = _jax_tree(params, jdt)
    jstate = jopt.adamw_init(jparams)
    # a second step: the state then holds nonzero moments and step 1
    jparams, jstate, _ = jopt.adamw_update(jcfg, jparams, _jax_tree(grads, jdt), jstate, 0.5)
    lr_scale = jnp.float32(0.7)
    jnew, jstate2, jmetrics = jopt.adamw_update(
        jcfg, jparams, _jax_tree(_tree(2, grad_scale), jdt), jstate, lr_scale)

    tdt = _TORCH[param_dtype]
    tparams = _torch_tree(params, tdt)
    state = adamw_init(tparams)
    adamw_update(cfg, tparams, _torch_tree(grads, tdt), state, 0.5)
    new, state2, metrics = adamw_update(
        cfg, tparams, _torch_tree(_tree(2, grad_scale), tdt), state,
        torch.tensor(0.7, dtype=torch.float32))

    assert new is tparams and state2 is state            # in place
    norm = float(metrics["grad_norm"])
    np.testing.assert_allclose(norm, float(jmetrics["grad_norm"]), rtol=1e-6)
    assert (norm > cfg.grad_clip) == clipped
    assert state2["step"].dtype == torch.int32 and int(state2["step"]) == int(jstate2["step"]) == 2
    for part in ("m", "v", "master"):
        ref = _flat(jstate2[part])
        for name, val in _flat(state2[part]).items():
            np.testing.assert_allclose(val, ref[name], err_msg=f"{part}.{name}", **_F32)
    ref = _flat(jnew)
    for name, val in _flat(new).items():
        assert flatten_tree(new)[name].dtype == tdt
        if param_dtype == "float32":
            np.testing.assert_allclose(val, ref[name], err_msg=name, **_F32)
        else:
            np.testing.assert_allclose(val, ref[name], err_msg=name, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_init_matches_jax(moment_dtype):
    params = _torch_tree(_tree(3), torch.float32)
    state = adamw_init(params, moment_dtype)
    jstate = jopt.adamw_init(_jax_tree(_tree(3), jnp.float32), moment_dtype)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    assert int(state["step"]) == int(jstate["step"]) == 0
    for part in ("m", "v"):
        for leaf in flatten_tree(state[part]).values():
            assert leaf.dtype == _TORCH[moment_dtype] and not leaf.any()
    for name, master in flatten_tree(state["master"]).items():
        p = flatten_tree(params)[name]
        # an explicit copy: an f32 param is not aliased
        assert master.dtype == torch.float32 and torch.equal(master, p)
        assert master.data_ptr() != p.data_ptr()


def test_bf16_moments_update_matches_jax():
    """Moments stored in bf16, the update math in f32, on both sides."""
    jcfg, cfg = jopt.AdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    jparams = _jax_tree(_tree(4), jnp.float32)
    jnew, jstate, _ = jopt.adamw_update(jcfg, jparams, _jax_tree(_tree(5), jnp.float32),
                                        jopt.adamw_init(jparams, "bfloat16"))
    params = _torch_tree(_tree(4), torch.float32)
    new, state, _ = adamw_update(cfg, params, _torch_tree(_tree(5), torch.float32),
                                 adamw_init(params, "bfloat16"))
    for part in ("m", "v"):
        ref = _flat(jstate[part])
        for name, val in _flat(state[part]).items():
            assert flatten_tree(state[part])[name].dtype == torch.bfloat16
            np.testing.assert_allclose(val, ref[name], rtol=2.0 ** -8, atol=0, err_msg=name)
    ref = _flat(jnew)
    for name, val in _flat(new).items():
        np.testing.assert_allclose(val, ref[name], err_msg=name, **_F32)


def test_global_norm_matches_jax():
    tree = _tree(6, 3.0)
    ref = float(jopt.global_norm(_jax_tree(tree, jnp.float32)))
    out = global_norm(_torch_tree(tree, torch.float32))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), ref, rtol=1e-6)
    bf = global_norm(_torch_tree(tree, torch.bfloat16))      # f32 squares of bf16 leaves
    np.testing.assert_allclose(float(bf), float(jopt.global_norm(_jax_tree(tree, jnp.bfloat16))),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup,total,min_frac", [(10, 20, 0.1), (100, 10_000, 0.1),
                                                   (0, 50, 0.0), (5, 5, 0.2)])
def test_warmup_cosine_matches_jax(warmup, total, min_frac):
    steps = np.arange(0, max(total, warmup) + 15, dtype=np.int32)
    ref = np.asarray(jopt.warmup_cosine(jnp.asarray(steps), warmup=warmup, total=total,
                                        min_frac=min_frac))
    out = warmup_cosine(torch.from_numpy(steps), warmup=warmup, total=total, min_frac=min_frac)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    # the int32 scalar step the trainer passes
    one = warmup_cosine(torch.tensor(3, dtype=torch.int32), warmup=warmup, total=total,
                        min_frac=min_frac)
    np.testing.assert_allclose(float(one), ref[3], rtol=1e-6, atol=1e-7)


def test_constant_matches_jax():
    steps = torch.arange(5, dtype=torch.int32)
    out = constant(steps, warmup=3)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jopt.constant(jnp.arange(5))))


def _bits_equal(a, b) -> bool:
    """Leaf-by-leaf equality of two trees, bit for bit."""
    fa, fb = flatten_tree(a), flatten_tree(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].view(torch.int16) if fa[k].dtype == torch.bfloat16 else fa[k],
                    fb[k].view(torch.int16) if fb[k].dtype == torch.bfloat16 else fb[k])
        for k in fa)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])
def test_cpu_leaves_take_the_eager_path_unchanged(monkeypatch, param_dtype, moment_dtype,
                                                  grad_scale):
    """Three steps on CPU leaves (the warmup's first scale 0, then two
    above it), each against JAX's step at the parity tolerances, and no
    kernel: the eager path holds the reference's arithmetic."""
    _no_kernel(monkeypatch)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    dt, jdt = _TORCH[param_dtype], jnp.dtype(param_dtype)
    params, jparams = _torch_tree(_tree(0), dt), _jax_tree(_tree(0), jdt)
    state, jstate = adamw_init(params, moment_dtype), jopt.adamw_init(jparams, moment_dtype)
    rel = {"float32": _F32, "bfloat16": dict(rtol=2.0 ** -8, atol=0)}
    for step, lr_scale in enumerate((0.0, 0.5, 0.7)):
        grads = _torch_tree(_tree(1 + step, grad_scale), dt)
        jgrads = _jax_tree(_tree(1 + step, grad_scale), jdt)
        assert not any(fused.takes(*leaf) for leaf in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(state["master"])))
        new, state, metrics = adamw_update(cfg, params, grads, state,
                                           torch.tensor(lr_scale, dtype=torch.float32))
        jparams, jstate, jmetrics = jopt.adamw_update(jcfg, jparams, jgrads, jstate,
                                                      jnp.float32(lr_scale))
        assert new is params
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for part, tol in (("m", rel[moment_dtype]), ("v", rel[moment_dtype]),
                          ("master", _F32)):
            ref = _flat(jstate[part])
            for name, val in _flat(state[part]).items():
                assert flatten_tree(state[part])[name].dtype == _TORCH[
                    "float32" if part == "master" else moment_dtype]
                np.testing.assert_allclose(val, ref[name], err_msg=f"{step} {part}.{name}",
                                           **tol)
        ref = _flat(jparams)
        for name, val in _flat(params).items():
            np.testing.assert_allclose(val, ref[name], err_msg=f"{step} {name}",
                                       **rel[param_dtype])


def test_dtensor_leaves_take_the_eager_path_unchanged(monkeypatch):
    """Replicated DTensor leaves on a CPU mesh of one: the eager path, the
    same bits as plain CPU leaves."""
    _no_kernel(monkeypatch)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    params = _torch_tree(_tree(0), torch.float32)
    state = adamw_init(params)
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")
        rep = lambda t: distribute_tensor(t.clone(), mesh, [Replicate(), Replicate()])  # noqa: E731
        dparams = tree_map(rep, _torch_tree(_tree(0), torch.float32))
        dstate = adamw_init(dparams)
        for step in range(2):
            grads = _torch_tree(_tree(1 + step, 10.0), torch.float32)
            dgrads = tree_map(rep, grads)
            _, _, metrics = adamw_update(cfg, params, grads, state, 0.5)
            _, _, dmetrics = adamw_update(cfg, dparams, dgrads, dstate, 0.5)
            full = lambda tree: tree_map(lambda t: t.full_tensor(), tree)  # noqa: E731
            assert torch.equal(dmetrics["grad_norm"].full_tensor(), metrics["grad_norm"])
            assert _bits_equal(full(dparams), params) and _bits_equal(full(dgrads), grads)
            for part in ("m", "v", "master"):
                assert _bits_equal(full(dstate[part]), state[part]), part
    finally:
        dist.destroy_process_group()


def test_meta_leaves_take_the_eager_path(monkeypatch):
    """The dry run's meta leaves: shapes and types only, no kernel."""
    _no_kernel(monkeypatch)
    params = tree_map(lambda t: t.to("meta"), _torch_tree(_tree(0), torch.bfloat16))
    state = adamw_init(params)
    grads = tree_map(torch.empty_like, params)
    new, state, metrics = adamw_update(AdamWConfig(), params, grads, state)
    assert metrics["grad_norm"].device.type == "meta"
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(new))


def _counts(fn):
    before = METRICS.snapshot()
    fn()
    moved = METRICS.delta(before).get("counters", {})
    return moved.get("optim.eager_params", 0), moved.get("optim.fused_params", 0)


def test_eager_params_are_counted_only_while_a_profiler_records():
    cfg = AdamWConfig()
    params = _torch_tree(_tree(0), torch.bfloat16)
    state = adamw_init(params)
    n = sum(p.numel() for p in tree_leaves(params))
    step = lambda: adamw_update(cfg, params, _torch_tree(_tree(1), torch.bfloat16),  # noqa: E731
                                state, 0.5)
    assert _counts(step) == (0, 0)

    def profiled():
        with profile(activities=[ProfilerActivity.CPU]):
            step()
            step()
    assert _counts(profiled) == (2 * n, 0)
    assert _counts(step) == (0, 0)


def test_the_fused_kernels_refuse_cpu_tensors():
    g = torch.zeros(4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.grad_sumsq([g])
    p, m, v, w = g.clone(), torch.zeros(4), torch.zeros(4), torch.zeros(4)
    one = torch.ones(())
    with pytest.raises(ValueError, match="contiguous CUDA leaves"):
        fused.update(p, g, m, v, w, one, one, one, one, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1)


def _stand_in_kernels():
    """CPU stand-ins of the two kernels, for the wiring around them: the
    eager ops, each leaf's sum of squares and then their sum in order."""
    def takes(p, g, m, v, master):
        return (all(type(t) in (torch.Tensor, torch.nn.Parameter) and t.is_contiguous()
                    and t.shape == p.shape for t in (p, g, m, v, master))
                and g.dtype == p.dtype and master.dtype == torch.float32)

    def grad_sumsq(grads):
        sums = [torch.sum(torch.square(g.float())) for g in grads]
        return torch.stack(sums + [sum(sums)])

    def update(p, g, m, v, master, scale, bc1, bc2, lr, **consts):
        assert takes(p, g, m, v, master)
        g.mul_(scale.to(g.dtype))
        adamw_mod._update_eager(AdamWConfig(**consts), [(p, g, m, v, master)], bc1, bc2, lr)
    return types.SimpleNamespace(takes=takes, grad_sumsq=grad_sumsq, update=update)


def _card_step(cfg, params, grads, state, lr_scale):
    """The card's path of :func:`adamw_update`, whatever the leaves' device."""
    return adamw_mod._update_fused(cfg, adamw_mod._leaves(params, grads, state), state,
                                   lr_scale)


def test_strided_leaves_go_through_contiguous_copies(monkeypatch):
    """A transposed param, its state and its grad: updated through
    contiguous copies written back, the eager step's bits on the same
    values laid out contiguously."""
    monkeypatch.setattr(adamw_mod, "fused", _stand_in_kernels())
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)

    def tree(seed, scale=1.0, strided=True):
        t = _torch_tree(_tree(seed, scale), torch.bfloat16)
        t["w"] = t["w"].t() if strided else t["w"].t().contiguous()
        return t
    params, ref = tree(0), tree(0, strided=False)
    state, ref_state = adamw_init(params), adamw_init(ref)
    assert not params["w"].is_contiguous() and not state["master"]["w"].is_contiguous()
    for step, lr_scale in enumerate((0.0, 0.5, 0.7)):
        grads, ref_grads = tree(1 + step, 10.0), tree(1 + step, 10.0, strided=False)
        norm = _card_step(cfg, params, grads, state, lr_scale)
        _, _, metrics = adamw_update_eager(cfg, ref, ref_grads, ref_state, lr_scale)
        assert torch.equal(norm, metrics["grad_norm"]) and float(norm) > cfg.grad_clip
        assert not grads["w"].is_contiguous()
        assert _bits_equal(params, ref) and _bits_equal(grads, ref_grads)
        for part in ("m", "v", "master", "step"):
            assert _bits_equal({"x": state[part]}, {"x": ref_state[part]}), (step, part)


def test_the_card_path_refuses_leaves_it_cannot_take(monkeypatch):
    """An f32 grad beside a bf16 param raises, as do DTensor leaves whose
    grad has another placement than the param, and plain leaves beside
    DTensor ones: no step falls back to the eager path unseen."""
    monkeypatch.setattr(adamw_mod, "fused", _stand_in_kernels())
    cfg = AdamWConfig()
    params = _torch_tree(_tree(0), torch.bfloat16)
    state = adamw_init(params)
    grads = _torch_tree(_tree(1), torch.bfloat16)
    grads["w"] = grads["w"].float()
    with pytest.raises(ValueError, match="a param and grad of one type"):
        _card_step(cfg, params, grads, state, 1.0)
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")
        place = lambda t, pl: distribute_tensor(t, mesh, pl)  # noqa: E731
        rows, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
        dparams = tree_map(lambda t: place(t, rows), _torch_tree(_tree(0), torch.float32))
        dstate = adamw_init(dparams)
        dgrads = tree_map(lambda t: place(t, rows), _torch_tree(_tree(1), torch.float32))
        dgrads["w"] = place(dgrads["w"].full_tensor(), rep)
        with pytest.raises(ValueError, match="share one mesh and one placement"):
            _card_step(cfg, dparams, dgrads, dstate, 1.0)
        dgrads["w"] = place(dgrads["w"].full_tensor(), rows)
        dparams["emb"] = dparams["emb"].full_tensor()
        dstate["m"]["emb"] = dstate["m"]["emb"].full_tensor()
        with pytest.raises(ValueError, match="share one mesh and one placement"):
            _card_step(cfg, dparams, dgrads, dstate, 1.0)
    finally:
        dist.destroy_process_group()


# each leaf's placements on a (2, 1) mesh: rows, columns, uneven rows
# (7 over 2), sharded only on the mesh dim of one rank, replicated
_SHARDED = {"w": [Shard(0), Replicate()], "emb": [Shard(0), Replicate()],
            "blocks": [{"b": [Shard(1), Replicate()], "a": [Replicate(), Shard(0)]},
                       {"b": [Replicate(), Replicate()], "a": [Shard(0), Replicate()]}]}


def _sharded_worker(rank: int, store_path: str, out_path: str) -> None:
    """One rank of the gloo mesh: three steps of the card's path (CPU
    stand-ins of the kernels) on sharded leaves beside the eager DTensor
    step, on the same leaves, to the rounding of the norm's sum."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                                world_size=2)
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        adamw_mod.fused = _stand_in_kernels()
        cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
        place = lambda tree: tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),  # noqa: E731
                                      _torch_tree(tree, torch.float32), _SHARDED)
        full = lambda tree: tree_map(lambda t: t.full_tensor(), tree)  # noqa: E731
        params, ref = place(_tree(0)), place(_tree(0))
        state, ref_state = adamw_init(params), adamw_init(ref)
        for step, lr_scale in enumerate((0.0, 0.5, 0.7)):
            grads, ref_grads = place(_tree(1 + step, 10.0)), place(_tree(1 + step, 10.0))
            norm = _card_step(cfg, params, grads, state, lr_scale)
            _, _, metrics = adamw_update_eager(cfg, ref, ref_grads, ref_state, lr_scale)
            assert isinstance(norm, DTensor) and all(pl.is_replicate() for pl in norm.placements)
            want = global_norm(_torch_tree(_tree(1 + step, 10.0), torch.float32))
            torch.testing.assert_close(norm.full_tensor(), want, rtol=1e-6, atol=0)
            torch.testing.assert_close(norm.full_tensor(), metrics["grad_norm"].full_tensor(),
                                       rtol=1e-6, atol=0)
            for a, b in ((params, ref), (grads, ref_grads), (state["m"], ref_state["m"]),
                         (state["v"], ref_state["v"]),
                         (state["master"], ref_state["master"])):
                torch.testing.assert_close(full(a), full(b), rtol=2e-6, atol=1e-9)
            assert int(state["step"].full_tensor()) == step + 1
        with open(out_path, "w") as f:
            f.write("ok")
    except BaseException:
        with open(out_path, "w") as f:
            f.write(traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_leaves_sum_their_squares_over_the_mesh(tmp_path):
    """Two gloo ranks: the card's path takes each DTensor leaf's local
    shard, and its norm (each leaf's sum reduced over the ranks it is
    sharded on, none over the mesh dim of one rank) is the whole tree's."""
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"out{r}" for r in range(2)]
    procs = [ctx.Process(target=_sharded_worker, args=(r, str(tmp_path / "store"), str(out)))
             for r, out in enumerate(outs)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(180)
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert [out.read_text() if out.exists() else "no result" for out in outs] == ["ok", "ok"]
