"""Port parity: ``repro_torch.models.layers`` vs ``repro.models.layers``.

Inputs come from numpy seeds and go to both frameworks; f32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

_TOL = 1e-6     # f32 elementwise work: only summation order differs


def _pair(arr, dtype=np.float32):
    arr = np.asarray(arr, dtype)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _close(t, j, tol=_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)))
    gj, gt = _pair(rng.normal(size=(64,)))
    _close(tl.rms_norm(xt, gt, 1e-5), jl.rms_norm(xj, gj, 1e-5))


def test_swiglu():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 3, 32)))
    ws = [_pair(rng.normal(size=s) / np.sqrt(s[0]))
          for s in ((32, 48), (32, 48), (48, 32))]
    out_t = tl.swiglu(xt, *(w[1] for w in ws))
    out_j = jl.swiglu(xj, *(w[0] for w in ws))
    _close(out_t, out_j, 1e-5)   # three matmuls of length 32-48


@pytest.mark.parametrize("hd,max_pos,theta", [(16, 40, 10_000.0),
                                              (128, 300, 500_000.0)])
def test_rope_frequencies_bit_equal(hd, max_pos, theta):
    # both tables are built in float64 numpy and cast once
    t = tl.rope_frequencies(hd, max_pos, theta, device="cpu")
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jl.rope_frequencies(hd, max_pos, theta)))


@pytest.mark.parametrize("pos_shape", [(1, 7), (3, 1)])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(3, pos_shape[1], 4, 32)))
    cs = tl.rope_frequencies(32, 64, 10_000.0, device="cpu")
    pos = rng.integers(0, 64, size=pos_shape)
    out_t = tl.apply_rope(xt, cs, torch.from_numpy(pos))
    out_j = jl.apply_rope(xj, jl.rope_frequencies(32, 64, 10_000.0),
                          jnp.asarray(pos))
    _close(out_t, out_j, 1e-5)


def test_apply_rope_clamps_positions_past_the_table():
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.normal(size=(1, 2, 2, 16)))
    pos = np.array([[5, 99]])
    out_t = tl.apply_rope(xt, tl.rope_frequencies(16, 8, 1e4, device="cpu"),
                          torch.from_numpy(pos))
    out_j = jl.apply_rope(xj, jl.rope_frequencies(16, 8, 1e4), jnp.asarray(pos))
    _close(out_t, out_j, 1e-6)


def test_embed_matches_take_including_out_of_range():
    rng = np.random.default_rng(4)
    tj, tt = _pair(rng.normal(size=(10, 8)))
    tokens = np.array([[0, 9, -1, -10], [10, -11, 3, 123]])
    out_t = tl.embed(tt, torch.from_numpy(tokens))
    out_j = jl.embed(tj, jnp.asarray(tokens))
    # jnp.take wraps [-V, 0) and fills rows outside [-V, V) with NaN
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert np.isnan(out_t.numpy()[1, :2]).all()


def test_unembed_is_f32():
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.normal(size=(2, 3, 16)))
    tj, tt = _pair(rng.normal(size=(50, 16)))
    out_t = tl.unembed(xt, tt)
    assert out_t.dtype == torch.float32
    _close(out_t, jl.unembed(xj, tj), 1e-5)


def test_initializer_is_seeded_and_fan_in_scaled():
    a = tl.Initializer(3, torch.float32, device="cpu").normal((256, 64))
    b = tl.Initializer(3, torch.float32, device="cpu").normal((256, 64))
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 1 / 16) < 5e-3
    z = tl.Initializer(0, torch.bfloat16, device="cpu").zeros((4,))
    assert z.dtype == torch.bfloat16 and not z.any()
