"""Port parity: the WKV recurrence.

The port's oracle ``reference_wkv`` (also the kernel's plain version),
``wkv_bhsd`` on CPU tensors and ``ops.rwkv_wkv`` vs the JAX Pallas kernel
in interpret mode; the model's ``wkv_chunked`` and ``wkv_scan_ref`` vs
their JAX counterparts.  Inputs come from numpy seeds, with the decay w
drawn per element, so a state transposed between its key and value axes
fails.  Tolerances: those of ``tests/test_kernels.py`` (f32 1e-5, bf16
2e-2) for the kernel family; 1e-5 scaled by the output for the model
functions, whose chunked form sums in another order; and
``tests/test_wkv_chunked.py``'s 5e-4 where the chunked form is held
against the sequential one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import reference_wkv as jax_reference_wkv
from repro.kernels import rwkv_wkv as jax_rwkv_wkv
from repro.models import rwkv as jrwkv
from repro_torch.kernels import (reference_wkv, rwkv_wkv, wkv_bhsd,
                                 wkv_bhsd_plain)
from repro_torch.models import rwkv as trwkv

# (b, s, h, hd, chunk of the JAX kernel): tests/test_kernels.py::TestRwkvWkv
_SHAPES = [(1, 16, 1, 8, 4), (2, 32, 2, 16, 8), (1, 64, 4, 64, 16),
           (2, 24, 2, 32, 24)]
_TOL = {"f32": 1e-5, "bf16": 2e-2}


def _inputs(b, s, h, hd, seed):
    """Model layout [B,S,H,hd] numpy f32, as TestRwkvWkv draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.95, size=(b, s, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _bhsd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _port(fn, r, k, v, w, u, s0, dtype=torch.float32):
    """Run one of the port's three kernel-family functions on model-layout
    numpy inputs; returns (out [B,S,H,hd], sT)."""
    if fn == "ops":
        return rwkv_wkv(*(_t(x, dtype) for x in (r, k, v, w, u)), _t(s0))
    out, sT = {"reference": reference_wkv, "wkv_bhsd": wkv_bhsd}[fn](
        *(_t(_bhsd(x), dtype) for x in (r, k, v, w)), _t(u, dtype), _t(s0))
    return out.transpose(1, 2), sT


@pytest.mark.parametrize("b,s,h,hd,chunk", _SHAPES)
@pytest.mark.parametrize("fn", ["reference", "wkv_bhsd", "ops"])
def test_matches_jax_kernel(fn, b, s, h, hd, chunk):
    args = _inputs(b, s, h, hd, seed=s + hd)
    ref, sT_ref = jax_rwkv_wkv(*(_j(x) for x in args), chunk=chunk, interpret=True)
    out, sT = _port(fn, *args)
    assert out.shape == (b, s, h, hd) and out.dtype == torch.float32
    assert sT.shape == (b, h, hd, hd) and sT.dtype == torch.float32
    _close(out, ref, _TOL["f32"])
    _close(sT, sT_ref, _TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["reference", "wkv_bhsd", "ops"])
def test_dtypes_match_jax_kernel(fn, dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    r, k, v, w, u, s0 = _inputs(1, 16, 2, 16, seed=5)
    ref, sT_ref = jax_rwkv_wkv(*(_j(x, jdt) for x in (r, k, v, w, u)), _j(s0),
                               chunk=8, interpret=True)
    out, sT = _port(fn, r, k, v, w, u, s0, dtype=tdt)
    assert out.dtype == tdt and sT.dtype == torch.float32
    _close(out, ref, _TOL[dtype])
    _close(sT, sT_ref, _TOL[dtype])


def test_model_mix_of_dtypes_matches_jax_oracle():
    """bf16 r/k/v/u with an f32 w and s0, as the model calls it: w is read
    in its own dtype on both sides."""
    r, k, v, w, u, s0 = _inputs(2, 20, 2, 16, seed=11)
    bf = lambda x: _j(x, jnp.bfloat16)  # noqa: E731
    ref, sT_ref = jax_reference_wkv(bf(_bhsd(r)), bf(_bhsd(k)), bf(_bhsd(v)),
                                    _j(_bhsd(w)), bf(u), _j(s0))
    tb = lambda x: _t(x, torch.bfloat16)  # noqa: E731
    out, sT = wkv_bhsd(tb(_bhsd(r)), tb(_bhsd(k)), tb(_bhsd(v)), _t(_bhsd(w)),
                       tb(u), _t(s0))
    assert out.dtype == torch.bfloat16
    _close(out, ref, _TOL["bf16"])
    _close(sT, sT_ref, _TOL["f32"])


def test_state_passing_equals_one_call():
    """[0:S/2] then [S/2:S] with the carried state equals one call, and
    S=1 steps (decode) equal it too; both match the JAX kernel."""
    r, k, v, w, u, s0 = _inputs(2, 32, 2, 16, seed=13)
    ref, sT_ref = jax_rwkv_wkv(*(_j(x) for x in (r, k, v, w, u, s0)), chunk=8,
                               interpret=True)
    sl = lambda a, b: [_t(x[:, a:b]) for x in (r, k, v, w)]  # noqa: E731
    o1, s_mid = rwkv_wkv(*sl(0, 16), _t(u), _t(s0))
    o2, s_end = rwkv_wkv(*sl(16, 32), _t(u), s_mid)
    _close(torch.cat([o1, o2], dim=1), ref, _TOL["f32"])
    _close(s_end, sT_ref, _TOL["f32"])
    state, steps = _t(s0), []
    for t in range(32):
        o, state = rwkv_wkv(*sl(t, t + 1), _t(u), state)
        steps.append(o)
    _close(torch.cat(steps, dim=1), ref, _TOL["f32"])
    _close(state, sT_ref, _TOL["f32"])


def test_ops_default_state_is_zeros():
    r, k, v, w, u, _ = _inputs(1, 8, 2, 8, seed=17)
    out, sT = rwkv_wkv(*(_t(x) for x in (r, k, v, w, u)))
    ref, sT_ref = rwkv_wkv(*(_t(x) for x in (r, k, v, w, u)),
                           torch.zeros((1, 2, 8, 8)))
    assert torch.equal(out, ref) and torch.equal(sT, sT_ref)


def test_plain_version_is_the_oracle_and_cpu_launches_nothing():
    assert wkv_bhsd_plain is reference_wkv
    before = wkv_bhsd.launches
    _port("wkv_bhsd", *_inputs(1, 4, 1, 8, seed=0))
    assert wkv_bhsd.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(k=np.zeros((1, 2, 5, 8))), "does not match"),
    (dict(u=np.zeros((2, 4))), r"\[H, hd\]"),
    (dict(s0=np.zeros((1, 2, 8, 4))), r"\[B, H, hd, hd\]"),
])
def test_shape_checks(bad, match):
    r, k, v, w, u, s0 = _inputs(1, 4, 2, 8, seed=0)
    args = dict(r=_bhsd(r), k=_bhsd(k), v=_bhsd(v), w=_bhsd(w), u=u, s0=s0)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        wkv_bhsd(*(_t(args[n]) for n in ("r", "k", "v", "w", "u", "s0")))


# ---------------------------------------------------------------------- #
# the model's two formulations
# ---------------------------------------------------------------------- #
def _model_inputs(b, s, h, hd, seed, strong_decay=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    hi = 8.0 if strong_decay else 1.0
    w = np.exp(-rng.uniform(1e-3, hi, size=(b, s, h, hd))).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _close_scaled(t, j, tol):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (1, 16, 1, 8, 4), (2, 37, 2, 16, 8),      # S not a multiple of chunk
    (1, 64, 4, 64, 16), (2, 5, 3, 8, 16),     # one short chunk
])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_chunked_matches_jax(b, s, h, hd, chunk, with_s0):
    r, k, v, w, u, s0 = _model_inputs(b, s, h, hd, seed=s * hd, strong_decay=True)
    s0 = s0 if with_s0 else None
    ref, sT_ref = jrwkv.wkv_chunked(*(_j(x) for x in (r, k, v, w, u)),
                                    None if s0 is None else _j(s0), chunk=chunk)
    out, sT = trwkv.wkv_chunked(*(_t(x) for x in (r, k, v, w, u)),
                                None if s0 is None else _t(s0), chunk=chunk)
    assert out.shape == (b, s, h, hd)
    _close_scaled(out, ref, 1e-5)
    _close_scaled(sT, sT_ref, 1e-5)


@pytest.mark.parametrize("b,s,h,hd", [(1, 16, 1, 8), (2, 24, 2, 32), (2, 1, 3, 16)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_scan_ref_matches_jax(b, s, h, hd, with_s0):
    r, k, v, w, u, s0 = _model_inputs(b, s, h, hd, seed=s + hd)
    s0 = s0 if with_s0 else None
    ref, sT_ref = jrwkv.wkv_scan_ref(*(_j(x) for x in (r, k, v, w, u)),
                                     s0=None if s0 is None else _j(s0))
    out, sT = trwkv.wkv_scan_ref(*(_t(x) for x in (r, k, v, w, u)),
                                 s0=None if s0 is None else _t(s0))
    assert out.dtype == torch.float32
    _close_scaled(out, ref, 1e-5)
    _close_scaled(sT, sT_ref, 1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_chunked_equals_sequential(seed):
    """tests/test_wkv_chunked.py's property, on the port, at its 5e-4."""
    rng = np.random.default_rng(1000 + seed)
    b, s, h = int(rng.integers(1, 3)), int(rng.integers(1, 41)), int(rng.integers(1, 4))
    hd, chunk = int(rng.choice([8, 16])), int(rng.choice([4, 8, 16]))
    r, k, v, w, u, s0 = (_t(x) for x in _model_inputs(
        b, s, h, hd, seed, strong_decay=bool(seed % 2)))
    o1, st1 = trwkv.wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
    o2, st2 = trwkv.wkv_scan_ref(r, k, v, w, u, s0)
    scale = max(1.0, float(o2.abs().max()))
    torch.testing.assert_close(o1, o2, atol=5e-4 * scale, rtol=5e-4)
    torch.testing.assert_close(st1, st2, atol=5e-4, rtol=5e-4)
