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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch.convert import flatten_tree, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, constant,
                               global_norm, warmup_cosine)

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


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (1e-3, False)])
def test_one_adamw_update_matches_jax(param_dtype, grad_scale, clipped):
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
