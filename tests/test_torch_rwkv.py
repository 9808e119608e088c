"""Port parity: the RWKV6 block and the ``rwkv6_1b6`` LM.

f32 on the CPU, weights carried from JAX (``load_jax_params``) or drawn
with numpy and handed to both.  Tolerances: 1e-5 scaled by the output for
one block (only summation order differs); 1e-4 for LM logits, a stack of
f32 matmuls summed in another order (``tests/test_torch_lm.py``'s bar);
2e-3 for the port's decode against its own forward
(``tests/test_archs_smoke.py::test_decode_matches_forward``), since
prefill runs the chunked WKV and decode the sequential one.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as JaxLM
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import flatten_tree, load_jax_params, to_numpy_tree
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models import rwkv as trwkv
from repro_torch.runtime import ServeLoop

_CFGS = {
    "rwkv6_1b6": get_smoke_config("rwkv6_1b6"),
    # more heads of a smaller size, three layers, a ragged chunk
    "rwkv6_1b6_h4": replace(get_smoke_config("rwkv6_1b6"), n_layers=3,
                            n_heads=4, n_kv_heads=4, head_dim=16),
}


def _pair(name, rwkv_chunk=4):
    cfg = _CFGS[name]
    jm = JaxLM(cfg, param_dtype=jnp.float32, rwkv_chunk=rwkv_chunk)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, rwkv_chunk=rwkv_chunk, device="cpu")
    load_jax_params(tm, tree)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm, tree


def _tokens(cfg, bsz=2, seq=11, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, seq))


def _block_params(d, h, hd, seed):
    """One time-mix block with every leaf random (mixes in (0, 1)), so a
    swapped projection or mix would show."""
    rng = np.random.default_rng(seed)
    cfg = replace(get_smoke_config("rwkv6_1b6"), d_model=d, n_heads=h,
                  n_kv_heads=h, head_dim=hd)
    tm = LM(replace(cfg, n_layers=1), param_dtype=torch.float32, device="cpu")
    shapes = {k[len("blocks.0.mixer."):]: tuple(p.shape[1:])
              for k, p in tm.named_parameters() if k.startswith("blocks.0.mixer.")}
    params = {}
    for name, shape in shapes.items():
        if name.startswith("mix_"):
            params[name] = rng.uniform(0, 1, shape)
        elif name in ("ln_x", "norm"):
            params[name] = 1 + 0.1 * rng.normal(size=shape)
        else:
            params[name] = rng.normal(size=shape) / np.sqrt(shape[0])
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return (jax.tree.map(jnp.asarray, params),
            {k: torch.from_numpy(v) for k, v in params.items()})


def test_config_alias():
    assert get_config("rwkv6-1.6b") is get_config("rwkv6_1b6")


def test_layer_specs_are_rwkv():
    *_, tm, _ = _pair("rwkv6_1b6")
    assert all(s.kind == "rwkv" for s in tm.specs)


@pytest.mark.parametrize("d,h,hd,s,chunk", [(64, 2, 32, 13, 4), (48, 3, 16, 16, 16)])
def test_rwkv_seq_matches_jax(d, h, hd, s, chunk):
    jp, tp = _block_params(d, h, hd, seed=d + s)
    x = np.random.default_rng(s).normal(size=(2, s, d)).astype(np.float32)
    ref = jrwkv.rwkv_seq(jp, jnp.asarray(x), h, hd, 1e-5, chunk=chunk)
    out = trwkv.rwkv_seq(tp, torch.from_numpy(x), h, hd, 1e-5, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_rwkv_step_matches_jax():
    d, h, hd = 64, 2, 32
    jp, tp = _block_params(d, h, hd, seed=7)
    rng = np.random.default_rng(8)
    jc = jrwkv.init_rwkv_cache(2, d, h, hd)
    tc = trwkv.init_rwkv_cache(2, d, h, hd, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32
    for t in range(5):
        x = rng.normal(size=(2, 1, d)).astype(np.float32)
        ref, jc = jrwkv.rwkv_step(jp, jnp.asarray(x), jc, h, hd)
        out, tc = trwkv.rwkv_step(tp, torch.from_numpy(x), tc, h, hd)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5, err_msg=f"t={t}")
        np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tc["last_x"].numpy(), np.asarray(jc["last_x"]))


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_param_round_trip_is_bit_exact(name):
    *_, tm, tree = _pair(name)
    back = flatten_tree(to_numpy_tree(tm))
    leaves = flatten_tree(tree)
    assert back.keys() == leaves.keys()
    assert "blocks.0.mixer.decay_a" in leaves
    for key, arr in leaves.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_forward_matches_jax(name):
    cfg, jm, jparams, tm, _ = _pair(name)
    tokens = _tokens(cfg)
    ref, _ = jm.forward(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens))
        last = tm(torch.from_numpy(tokens), last_only=True)
    assert out.shape == (2, 11, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref)[:, -1:],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_decode_matches_jax_and_forward(name):
    cfg, jm, jparams, tm, _ = _pair(name)
    tokens = _tokens(cfg)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    tcache = tm.init_cache(2, 32, dtype=torch.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in tcache] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in jcache]
    with torch.no_grad():
        fwd = tm(torch.from_numpy(tokens))
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            ref, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), t)
            out, tcache = tm.decode_step(tcache, torch.from_numpy(tok), t)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4, err_msg=f"t={t}")
            err = float((out[:, 0] - fwd[:, t]).abs().max())
            assert err < 2e-3, f"t={t}: {err}"
    np.testing.assert_allclose(tcache[0]["state"].numpy(),
                               np.asarray(jcache[0]["state"]), atol=1e-4, rtol=1e-4)


def test_kernel_route_matches_chunked_route(monkeypatch):
    """The card's prefill route — ``ops.rwkv_wkv`` from a zero state, in
    model layout — run on the CPU through the plain version, against
    the chunked CPU route, at the prefill-vs-decode bar."""
    cfg, _, _, tm, _ = _pair("rwkv6_1b6_h4")
    tokens = torch.from_numpy(_tokens(cfg, seq=19))
    with torch.no_grad():
        chunked = tm(tokens)
        calls = []

        def kernel_route(r, k, v, w, u, s0=None, chunk=16):
            calls.append(r.shape)
            assert s0 is None
            return ops.rwkv_wkv(r, k, v, w, u)

        monkeypatch.setattr(trwkv, "wkv_chunked", kernel_route)
        sequential = tm(tokens)
    assert len(calls) == cfg.n_layers
    assert float((sequential - chunked).abs().max()) < 2e-3


def test_serve_loop_refuses_rwkv():
    *_, tm, _ = _pair("rwkv6_1b6")
    with pytest.raises(ValueError, match="attention caches"):
        ServeLoop(tm)


def test_serve_main_on_cpu():
    assert serve.main(["--arch", "rwkv6_1b6", "--device", "cpu"]) == 0
