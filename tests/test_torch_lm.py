"""Port parity: ``LM`` on weights carried from JAX ``LM.init``, for every
layer kind: dense and MoE attention, Mamba (jamba), cross-attention to a
frontend (the VLM, with and without ``frontend_proj``) and the
encoder-decoder.

f32 on the CPU.  Logits agree with JAX to 1e-4 (the stack of matmuls
sums in another order); the port's own decode agrees with its forward to
2e-3, the bar of ``tests/test_archs_smoke.py::test_decode_matches_forward``,
at its capacity factor of 16, where no MoE token is dropped.  The
forward runs at the default capacity factor of 1.25, where the smoke MoE
configs drop tokens, as JAX's does.  Archs with a frontend get the same
seeded frontend embeddings on both sides (decode reads the memory that
``encode_memory`` prepared once).  Mamba runs 4-step chunks, 3 of them at
S = 12 (JAX's ``mamba_seq`` takes only chunk multiples; see
``tests/test_torch_ssm.py``).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import flatten_tree, load_jax_params, to_numpy_tree
from repro_torch.models import LM

_CFGS = {
    "llama3_8b": get_smoke_config("llama3_8b"),
    # deeper and narrower: 3 layers, MQA, hd 32
    "llama3_8b_deep_mqa": replace(get_smoke_config("llama3_8b"), n_layers=3,
                                  n_heads=2, n_kv_heads=1),
    "qwen25_32b": get_smoke_config("qwen25_32b"),      # qkv bias, 5:1, hd 16
    "olmoe_1b_7b": get_smoke_config("olmoe_1b_7b"),    # MoE, 8 experts top-2
    "mixtral_8x7b": get_smoke_config("mixtral_8x7b"),  # MoE, 4 experts top-2, GQA
    # mamba, mamba+MoE, mamba, attn+MoE
    "jamba_15_large": get_smoke_config("jamba_15_large"),
    # cross-attention every 2nd layer to 16 frontend tokens, GQA
    "llama32_vision_90b": get_smoke_config("llama32_vision_90b"),
    # the frontend's width is not d_model: frontend_proj
    "llama32_vision_90b_proj": replace(get_smoke_config("llama32_vision_90b"),
                                       frontend_dim=48),
    # 2 encoder and 2 decoder layers over 24 frames
    "seamless_m4t_v2": get_smoke_config("seamless_m4t_v2"),
}


def _pair(name, max_seq=32, capacity_factor=1.25):
    cfg = _CFGS[name]
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=8, mamba_chunk=4,
               max_seq=max_seq, capacity_factor=capacity_factor)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8, mamba_chunk=4, max_seq=max_seq,
            capacity_factor=capacity_factor, device="cpu")
    load_jax_params(tm, tree)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm, tree


def _tokens(cfg, bsz=2, seq=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, seq))


def _frontend(cfg, bsz=2, seed=1):
    """Seeded stub frontend embeddings, or None for an arch without one."""
    if not cfg.frontend_tokens:
        return None
    rng = np.random.default_rng(seed + 100)
    return rng.normal(size=(bsz, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _as(fn, arr):
    return None if arr is None else fn(arr)


def test_configs_are_copies():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_smoke_config(arch).__dict__ == jax_smoke_config(arch).__dict__
        assert get_config(arch).__dict__ == jax_config(arch).__dict__


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_param_round_trip_is_bit_exact(name):
    *_, tm, tree = _pair(name)
    back = flatten_tree(to_numpy_tree(tm))
    leaves = flatten_tree(tree)
    assert back.keys() == leaves.keys()
    for key, arr in leaves.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_forward_matches_jax(name):
    cfg, jm, jparams, tm, _ = _pair(name)
    tokens, frontend = _tokens(cfg), _frontend(cfg)
    ref, _ = jm.forward(jparams, jnp.asarray(tokens, jnp.int32), _as(jnp.asarray, frontend))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens), _as(torch.from_numpy, frontend))
        last = tm(torch.from_numpy(tokens), _as(torch.from_numpy, frontend), last_only=True)
    assert out.shape == (2, 12, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref)[:, -1:],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_decode_matches_jax_and_forward(name):
    cfg, jm, jparams, tm, _ = _pair(name, capacity_factor=16.0)
    tokens, frontend = _tokens(cfg), _frontend(cfg)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    tcache = tm.init_cache(2, 32, dtype=torch.float32)
    jmem = jm.encode_memory(jparams, _as(jnp.asarray, frontend))
    with torch.no_grad():
        tmem = tm.encode_memory(_as(torch.from_numpy, frontend))
        fwd = tm(torch.from_numpy(tokens), _as(torch.from_numpy, frontend))
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            ref, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), t, memory=jmem)
            out, tcache = tm.decode_step(tcache, torch.from_numpy(tok), t, memory=tmem)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4, err_msg=f"t={t}")
            err = float((out[:, 0] - fwd[:, t]).abs().max())
            assert err < 2e-3, f"t={t}: {err}"


def test_decode_with_per_slot_positions_matches_jax():
    cfg, jm, jparams, tm, _ = _pair("llama3_8b")
    tokens = _tokens(cfg, bsz=3, seq=4, seed=2)
    pos = np.array([0, 5, 9], np.int32)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(3, 16, dtype=jnp.float32)
    tcache = tm.init_cache(3, 16, dtype=torch.float32)
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            ref, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos + t))
            out, tcache = tm.decode_step(tcache, torch.from_numpy(tok),
                                         torch.from_numpy(pos + t))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache[0]["k"].numpy(),
                               np.asarray(jcache[0]["k"]), atol=1e-5, rtol=1e-5)
