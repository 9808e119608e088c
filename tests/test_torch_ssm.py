"""Port parity: the Mamba block (``repro_torch.models.ssm``) against JAX's
``repro.models.ssm`` on the same parameters and inputs.

f32 on the CPU.  The in-chunk scan is ``jax.lax.associative_scan``'s own
tree, so it equals JAX's to f32 rounding (1e-6 relative; it is bit-equal
here).  ``mamba_seq`` and ``mamba_step`` agree with JAX to atol = rtol =
1e-5: the projections are matmuls that sum in another order (largest
difference seen 1.9e-6 against outputs of about 5).  JAX's ``mamba_seq``
takes only S a multiple of its chunk: otherwise it adds the padded skip
term to the unpadded output and raises (or, at S = 1, broadcasts).  The
port pads and cuts both, so at a ragged S it is held against JAX run with
a chunk that divides S: the scan's result does not depend on the chunk.
bf16: the projections and the depthwise conv (a sum of K products in
bf16, JAX's order) are bit-equal; XLA's bf16 ``silu`` rounds some
elements one ulp apart from torch's, each later stage then stays within
one bf16 ulp of JAX's, and the output is held to two bf16 ulps (2**-6) of
JAX's largest |output| (largest gap seen 0.1875 against 14.0: 1.3 %).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.layers import Initializer as JaxInitializer
from repro_torch.convert import _to_tensor
from repro_torch.models import ssm
from repro_torch.models.layers import Initializer

_TOL = dict(atol=1e-5, rtol=1e-5)
D_MODEL, D_STATE, D_CONV, EXPAND = 16, 4, 4, 2


def _params(dtype=jnp.float32, seed=0):
    jp = jssm.init_mamba(JaxInitializer(seed, dtype), D_MODEL, D_STATE, D_CONV, EXPAND)
    return jp, {k: _to_tensor(np.asarray(v)) for k, v in jp.items()}


def _x(b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, D_MODEL)).astype(np.float32)


def _combine(e1, e2):
    return e1[0] * e2[0], e1[1] * e2[0] + e2[1]


@pytest.mark.parametrize("length", [1, 2, 3, 5, 8, 13, 64])
def test_associative_scan_is_jax_tree(length):
    rng = np.random.default_rng(length)
    d = rng.uniform(0.5, 1.0, size=(2, length, 3, 4)).astype(np.float32)
    i = rng.normal(size=(2, length, 3, 4)).astype(np.float32)
    ref = jax.lax.associative_scan(_combine, (jnp.asarray(d), jnp.asarray(i)), axis=1)
    got = ssm._associative_scan([torch.from_numpy(d), torch.from_numpy(i)])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def test_init_matches_jax_layout():
    jp, _ = _params()
    tp = ssm.init_mamba(Initializer(0, torch.float32, "cpu"), D_MODEL, D_STATE, D_CONV,
                        EXPAND)
    assert list(tp) == list(jp)
    for name, arr in jp.items():
        assert tuple(tp[name].shape) == arr.shape, name
    np.testing.assert_array_equal(tp["a_log"].numpy(), np.asarray(jp["a_log"]))


@pytest.mark.parametrize("s,chunk,jax_chunk", [
    (12, 4, 4),        # three chunks
    (16, 16, 16),      # one whole chunk
    (64, 16, 16),
    (7, 4, 7),         # ragged: padded to 8, cut back to 7
    (33, 8, 11),
    (10, 256, 10),     # shorter than the default chunk
    (1, 4, 1),
])
def test_mamba_seq_matches_jax(s, chunk, jax_chunk):
    jp, tp = _params()
    x = _x(2, s)
    ref = jssm.mamba_seq(jp, jnp.asarray(x), chunk=jax_chunk)
    with torch.no_grad():
        out = ssm.mamba_seq(tp, torch.from_numpy(x), chunk=chunk)
    assert out.shape == (2, s, D_MODEL) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_TOL)


def test_jax_mamba_seq_takes_only_chunk_multiples():
    """The reference fault the ragged cases work around."""
    jp, _ = _params()
    with pytest.raises(TypeError, match="broadcast"):
        jssm.mamba_seq(jp, jnp.asarray(_x(2, 7)), chunk=4)


def test_mamba_seq_gradients_match_jax():
    """Gradients through the checkpointed chunks, for the input and
    every parameter, against ``jax.grad``."""
    jp, tp = _params()
    x = _x(2, 12)
    w = np.random.default_rng(3).normal(size=(2, 12, D_MODEL)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba_seq(p, xx, chunk=4) * w)
    ref_p, ref_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (ssm.mamba_seq(leaves, xt, chunk=4) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), atol=5e-5, rtol=1e-4)
    for name, p in leaves.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_p[name]), atol=5e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("param_dtype", [jnp.float32, jnp.bfloat16])
def test_mamba_step_matches_jax_and_seq(param_dtype):
    """Decode steps with an f32 cache, as ``greedy_decode`` keeps it, under
    f32 and bf16 weights: the conv cache comes back in its own dtype, the
    state in f32; in f32 the steps equal JAX's and the port's own
    ``mamba_seq``."""
    jp, tp = _params(param_dtype)
    tdtype = torch.float32 if param_dtype == jnp.float32 else torch.bfloat16
    x = _x(2, 9)
    jcache = jssm.init_mamba_cache(2, D_MODEL, D_STATE, D_CONV, EXPAND, jnp.float32)
    tcache = ssm.init_mamba_cache(2, D_MODEL, D_STATE, D_CONV, EXPAND, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        jo, jcache = jssm.mamba_step(jp, jnp.asarray(x[:, t:t + 1], param_dtype), jcache)
        with torch.no_grad():
            to, tcache = ssm.mamba_step(tp, torch.from_numpy(x[:, t:t + 1]).to(tdtype), tcache)
        assert to.dtype == tdtype
        assert tcache["conv"].dtype == tcache["ssm"].dtype == torch.float32
        outs.append(to)
        if param_dtype == jnp.float32:
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), **_TOL, err_msg=f"t={t}")
            np.testing.assert_allclose(tcache["ssm"].numpy(), np.asarray(jcache["ssm"]),
                                       **_TOL)
    np.testing.assert_allclose(tcache["conv"].numpy(),
                               np.asarray(jcache["conv"].astype(jnp.float32)), **_TOL)
    if param_dtype == jnp.float32:
        with torch.no_grad():
            seq = ssm.mamba_seq(tp, torch.from_numpy(x), chunk=4)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), seq.numpy(), **_TOL)


def test_mamba_seq_bf16_within_two_ulps_of_jax():
    jp, tp = _params(jnp.bfloat16)
    x = jnp.asarray(_x(2, 16), jnp.bfloat16)
    ref = np.asarray(jssm.mamba_seq(jp, x, chunk=8).astype(jnp.float32))
    with torch.no_grad():
        out = ssm.mamba_seq(tp, _to_tensor(np.asarray(x)), chunk=8)
    assert out.dtype == torch.bfloat16
    gap = np.abs(out.float().numpy() - ref).max()
    assert gap <= 2.0 ** -6 * np.abs(ref).max(), gap
