"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe``.

f32 on the CPU, on the same numpy inputs and weights.  Bars: y within
atol = rtol = 1e-5 (the expert products and the combine sum in another
order: the port gathers each token's k outputs and sums them, JAX
scatter-adds them); aux within 1e-6; every gradient within 1e-5 of its
largest magnitude.  The selection (which token each expert slot holds)
must equal JAX's exactly, ties included: JAX's is read back from the
gathered activations that its ``shard`` hook sees, whose rows are the
token rows of x.  The first six tests are the counterparts of
``tests/test_moe.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import Initializer as JaxInitializer
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.models.layers import swiglu
from repro_torch.models.moe import moe_capacity, moe_ffn, moe_route

_Y_TOL = dict(atol=1e-5, rtol=1e-5)


def _params(d=16, f=32, e=4, seed=0):
    """JAX's init drawn once, as numpy, and the port's tensors of it."""
    tree = jax.tree.map(np.asarray, jax_init_moe(JaxInitializer(seed, jnp.float32), d, f, e))
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rows_of(xs, x):
    """Token index of every [G,E,C] slot of ``xs``, by matching its rows
    with the (distinct) token rows of ``x`` [G,T,d]."""
    match = (np.asarray(xs)[:, :, :, None, :] == np.asarray(x)[:, None, None, :, :]).all(-1)
    assert (match.sum(-1) == 1).all(), "a slot matched no token row, or several"
    return match.argmax(-1)


def _jax_run(tree, x, **kw):
    """(y, aux, the selected tokens [G,E,C]) of the JAX function."""
    seen = {}

    def shard(v, kind):
        seen.setdefault(kind, v)
        return v
    y, aux = jax_moe_ffn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), shard=shard, **kw)
    return np.asarray(y), float(aux), _rows_of(seen["moe_tokens"], x)


def test_capacity_formula():
    assert moe_capacity(128, 8, 2, 1.25) == 40
    assert moe_capacity(4, 64, 8, 1.0) == 1     # floor at 1
    assert moe_capacity(16, 2, 2, 100.0) == 16  # cap at tokens


def test_no_drop_regime_matches_manual_mixture():
    """With capacity >= tokens, expert-choice == token-choice: the output
    equals the gate-weighted mixture of expert FFNs."""
    _, p = _params()
    x = torch.from_numpy(_x((2, 8, 16), 0))
    y, _ = moe_ffn(p, x, top_k=2, capacity_factor=100.0)
    probs = torch.softmax(x @ p["router"], dim=-1)
    top_vals, top_idx = torch.topk(probs, 2)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    expert_out = torch.stack([swiglu(x, p["w_gate"][e], p["w_up"][e], p["w_down"][e])
                              for e in range(4)], dim=2)          # [G, T, E, d]
    manual = torch.zeros_like(x)
    for k in range(2):
        sel = torch.take_along_dim(expert_out, top_idx[..., k][..., None, None], dim=2)[..., 0, :]
        manual = manual + top_vals[..., k][..., None] * sel
    torch.testing.assert_close(y, manual, **_Y_TOL)


def test_tight_capacity_drops_tokens():
    tree, p = _params()
    x = _x((1, 32, 16), 1)
    y_tight, _ = moe_ffn(p, torch.from_numpy(x), top_k=2, capacity_factor=0.25)
    y_loose, _ = moe_ffn(p, torch.from_numpy(x), top_k=2, capacity_factor=100.0)
    assert int((y_tight[0].norm(dim=-1) == 0.0).sum()) > 0
    assert float((y_tight - y_loose).norm()) > 0
    assert moe_route(p, torch.from_numpy(x), top_k=2, capacity_factor=0.25).dropped() > 0
    ref, _, _ = _jax_run(tree, x, top_k=2, capacity_factor=0.25)
    np.testing.assert_allclose(y_tight.numpy(), ref, **_Y_TOL)


def test_aux_loss_and_selection_when_every_probability_ties():
    """A zero router makes every probability 1/E: aux is k at perfect
    balance, and both top-k steps break the ties by index as JAX does."""
    tree, p = _params(seed=2)
    tree["router"] = np.zeros_like(tree["router"])
    p["router"] = torch.zeros_like(p["router"])
    x = _x((2, 64, 16), 2)
    y, aux = moe_ffn(p, torch.from_numpy(x), top_k=2)
    assert float(aux) == pytest.approx(2.0, abs=0.05)
    ref_y, ref_aux, ref_sel = _jax_run(tree, x, top_k=2)
    route = moe_route(p, torch.from_numpy(x), top_k=2)
    np.testing.assert_array_equal(route.sel_tok.numpy(), ref_sel)
    assert (route.top_idx.numpy() == [0, 1]).all()       # the lowest indices
    np.testing.assert_allclose(y.numpy(), ref_y, **_Y_TOL)
    assert abs(float(aux) - ref_aux) <= 1e-6


def test_gradients_reach_all_used_experts():
    _, p = _params(seed=3)
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.from_numpy(_x((1, 16, 16), 3))
    y, aux = moe_ffn(p, x, top_k=2, capacity_factor=2.0)
    ((y ** 2).mean() + 0.01 * aux).backward()
    assert bool(torch.isfinite(p["w_gate"].grad).all())
    assert float(p["router"].grad.abs().max()) > 0


def test_shard_hook_is_called():
    calls = []
    _, p = _params()
    moe_ffn(p, torch.zeros((1, 8, 16)), top_k=2,
            shard=lambda v, kind: calls.append(kind) or v)
    assert calls == ["moe_tokens", "moe_hidden", "moe_tokens"]


# (G, T, d, f, E, k, capacity factor): the smoke sizes of olmoe_1b_7b and
# mixtral_8x7b, a tight and a loose capacity, and decode's groups of one
# token (capacity 1)
_CASES = [
    (2, 16, 64, 96, 8, 2, 1.25),      # olmoe_1b_7b smoke
    (2, 16, 64, 128, 4, 2, 1.25),     # mixtral_8x7b smoke
    (1, 32, 16, 32, 4, 2, 0.25),
    (2, 24, 16, 32, 8, 3, 16.0),
    (4, 1, 64, 96, 8, 2, 1.25),       # a decode step of batch 4
]


@pytest.mark.parametrize("g,t,d,f,e,k,cf", _CASES)
def test_moe_ffn_matches_jax(g, t, d, f, e, k, cf):
    tree, p = _params(d, f, e, seed=g + t + e)
    x = _x((g, t, d), 7)
    ref_y, ref_aux, ref_sel = _jax_run(tree, x, top_k=k, capacity_factor=cf)
    route = moe_route(p, torch.from_numpy(x), top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(route.sel_tok.numpy(), ref_sel)
    y, aux = moe_ffn(p, torch.from_numpy(x), top_k=k, capacity_factor=cf)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), ref_y, **_Y_TOL)
    assert abs(float(aux) - ref_aux) <= 1e-6


@pytest.mark.parametrize("g,t,d,f,e,k,cf", _CASES[:3])
def test_moe_gradients_match_jax(g, t, d, f, e, k, cf):
    tree, p = _params(d, f, e, seed=g + t + e)
    x = _x((g, t, d), 8)
    dy = _x((g, t, d), 9)

    def jax_loss(params, xx):
        y, aux = jax_moe_ffn(params, xx, top_k=k, capacity_factor=cf)
        return jnp.sum(y * dy) + 0.01 * aux
    ref_p, ref_x = jax.grad(jax_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree),
                                                      jnp.asarray(x))
    p = {name: v.requires_grad_() for name, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe_ffn(p, xt, top_k=k, capacity_factor=cf)
    ((y * torch.from_numpy(dy)).sum() + 0.01 * aux).backward()
    got = {**{name: v.grad for name, v in p.items()}, "x": xt.grad}
    ref = {**{name: np.asarray(v) for name, v in ref_p.items()}, "x": np.asarray(ref_x)}
    for name, r in ref.items():
        scale = float(np.abs(r).max())
        assert scale > 0, name
        err = float(np.abs(got[name].numpy() - r).max())
        assert err <= 1e-5 * scale, f"{name}: {err} vs {scale}"


def test_two_calls_are_bit_equal_and_drops_are_counted():
    _, p = _params(d=64, f=96, e=8)
    x = torch.from_numpy(_x((2, 16, 64), 10))
    first, second = (moe_ffn(p, x, top_k=2) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    route = moe_route(p, x, top_k=2)
    routed = int((route.routed > 0).sum())
    assert routed == 2 * 2 * 16
    assert route.dropped() == routed - int((route.sel_vals > 0).sum())
    assert moe_route(p, x, top_k=2, capacity_factor=16.0).dropped() == 0
