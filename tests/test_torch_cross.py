"""Port parity: cross-attention, the encoder and the frontend memory, and
the archs that use them (llama32_vision_90b, seamless_m4t_v2) or Mamba
(jamba_15_large) through the serving entry points; port counterparts of
``tests/test_archs_smoke.py``'s layer-pattern, encoder, decode, int8 and
parameter-count tests.

f32 on the CPU.  ``cross_attention`` is the chunked scan on both sides:
atol = rtol = 2e-5, ``tests/test_torch_attention.py``'s bar for the
scan.  ``encode_memory`` agrees with JAX to 1e-4 (a stack of matmuls
summed in another order), as ``tests/test_torch_lm.py``'s forward.
Decode within 2e-3 of forward, and int8 decode within 5 % of the bf16
logits, are the JAX tests' own bars.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import greedy_decode as jax_greedy_decode
from repro.models import LM as JaxLM
from repro.models import attention as jattn
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import load_jax_params
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models import attention as attn
from repro_torch.runtime import Request, ServeLoop

_NEW_ARCHS = ["jamba_15_large", "llama32_vision_90b", "seamless_m4t_v2"]


def _frontend(cfg, bsz=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(bsz, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _pair(cfg, **kw):
    kw = dict(param_dtype=jnp.float32, attn_chunk=8, mamba_chunk=4, max_seq=64, **kw)
    jm = JaxLM(cfg, **kw)
    tree = jax.tree.map(np.asarray, jm.init(0))
    kw["param_dtype"] = torch.float32
    tm = LM(cfg, device="cpu", **kw)
    load_jax_params(tm, tree)
    return jm, jax.tree.map(jnp.asarray, tree), tm


def _port_model(cfg, **kw):
    """The JAX test's ``make_model``: the port's own seeded weights."""
    kw = dict(param_dtype=torch.float32, attn_chunk=8, mamba_chunk=4, max_seq=32, **kw)
    return LM(cfg, device="cpu", **kw)


@pytest.mark.parametrize("b,sq,sm,hq,hkv,hd,chunk", [
    (2, 12, 24, 4, 4, 16, 8),     # MHA, memory longer than the queries
    (2, 12, 16, 4, 2, 16, 8),     # GQA 2:1 (the VLM smoke config)
    (1, 5, 37, 8, 2, 32, 16),     # ragged memory: the last chunk padded
    (2, 1, 19, 4, 1, 16, 512),    # a decode step's one query, MQA, one chunk
])
def test_cross_attention_matches_jax(b, sq, sm, hq, hkv, hd, chunk):
    rng = np.random.default_rng(sq + sm)
    q = rng.normal(size=(b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, sm, hkv, hd)).astype(np.float32) for _ in range(2))
    ref = jattn.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk)
    out = attn.cross_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk)
    assert out.shape == (b, sq, hq, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_cross_attention_never_launches_the_flash_kernel(monkeypatch):
    """No kernel takes a memory of another length than the queries: the
    scan serves every device, so the kernel wrapper is never called."""
    def refuse(*a, **kw):
        raise AssertionError("cross_attention reached the flash kernel")
    monkeypatch.setattr(attn.ops, "flash_attention", refuse)
    x = torch.randn(1, 4, 2, 16)
    assert attn.cross_attention(x, torch.randn(1, 9, 2, 16), torch.randn(1, 9, 2, 16)).shape \
        == (1, 4, 2, 16)


@pytest.mark.parametrize("name,change", [
    ("seamless_m4t_v2", {}),                      # through the encoder
    ("llama32_vision_90b", {}),                   # the frontend itself
    ("llama32_vision_90b", {"frontend_dim": 48}),  # through frontend_proj
])
def test_encode_memory_matches_jax(name, change):
    cfg = replace(get_smoke_config(name), **change)
    jm, jparams, tm = _pair(cfg)
    fe = _frontend(cfg)
    ref = jm.encode_memory(jparams, jnp.asarray(fe))
    with torch.no_grad():
        mem = tm.encode_memory(torch.from_numpy(fe))
    assert mem.shape == (2, cfg.frontend_tokens, cfg.d_model)
    assert ("frontend_proj" in dict(tm.named_parameters())) == bool(change)
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert tm.encode_memory(None) is None


def test_jamba_layer_pattern():
    m = _port_model(get_smoke_config("jamba_15_large"))
    kinds = [s.kind for s in m.specs]
    moes = [s.moe for s in m.specs]
    assert kinds == ["mamba", "mamba", "mamba", "attn"]
    assert moes == [False, True, False, True]
    # the full config at 4 layers keeps its attention period of 8: the
    # period falls back to the unrolled 4 layers, none of them attention
    m8 = _port_model(replace(get_config("jamba_15_large"), n_layers=4, d_model=64,
                             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, n_experts=4))
    assert m8.period == 4 and [s.kind for s in m8.specs] == ["mamba"] * 4


def test_vlm_cross_attention_period():
    cfg = get_smoke_config("llama32_vision_90b")
    m = _port_model(cfg)
    crosses = [s.cross for s in m.specs]
    assert sum(crosses) == len(crosses) // cfg.cross_attn_period
    j = crosses.index(True)
    assert set(m.blocks[j].cross.rep(0)) == {"norm", "wq", "wk", "wv", "wo"}


def test_encdec_has_encoder_params():
    cfg = get_smoke_config("seamless_m4t_v2")
    m = _port_model(cfg)
    names = dict(m.named_parameters())
    assert names["encoder.mixer.wq"].shape[0] == cfg.n_encoder_layers
    assert "enc_norm" in names and all(s.cross for s in m.specs)
    with torch.no_grad():
        mem = m.encode_memory(torch.from_numpy(_frontend(cfg)))
    assert mem.shape == (2, cfg.frontend_tokens, cfg.d_model)


@pytest.mark.parametrize("arch", _NEW_ARCHS)
def test_decode_matches_forward(arch):
    cfg = get_smoke_config(arch)
    m = _port_model(cfg, capacity_factor=16.0)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    fe = torch.from_numpy(_frontend(cfg, seed=1)) if cfg.frontend_tokens else None
    with torch.no_grad():
        ref = m(tokens, fe)
        mem = m.encode_memory(fe)
        cache = m.init_cache(2, 32, dtype=torch.float32)
        for t in range(tokens.shape[1]):
            logits, cache = m.decode_step(cache, tokens[:, t:t + 1], t, memory=mem)
            err = float((logits[:, 0] - ref[:, t]).abs().max())
            assert err < 2e-3, f"t={t}: {err}"


def test_int8_kv_cache_decode_vision():
    """Quantized KV decode with cross-attention memory within 5 % of the
    forward logits, and equal to JAX's int8 decode."""
    cfg = get_smoke_config("llama32_vision_90b")
    jm, jparams, tm = _pair(cfg, capacity_factor=16.0, kv_dtype="int8")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    fe = _frontend(cfg, seed=3)
    jmem = jm.encode_memory(jparams, jnp.asarray(fe))
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    jstep = jax.jit(jm.decode_step)
    with torch.no_grad():
        ref = tm(torch.from_numpy(tokens), torch.from_numpy(fe))
        mem = tm.encode_memory(torch.from_numpy(fe))
        cache = tm.init_cache(2, 32, dtype=torch.float32)
        worst = 0.0
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            logits, cache = tm.decode_step(cache, torch.from_numpy(tok), t, memory=mem)
            jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), t, memory=jmem)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
            worst = max(worst, float((logits[:, 0] - ref[:, t]).abs().max()))
    assert worst / float(ref.abs().max()) < 0.05
    assert cache[0]["k"].dtype == torch.int8


def test_full_configs_param_counts():
    """Every one of the ten arch copies counts JAX's parameters, and the
    published sizes hold (±10 %), as in the JAX test."""
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_config(arch).total_params() == jax_config(arch).total_params(), arch
    expected = {"mixtral_8x7b": 46.7e9, "olmoe_1b_7b": 6.9e9, "qwen25_32b": 32.5e9,
                "llama3_8b": 8.0e9, "jamba_15_large": 398e9, "llama32_vision_90b": 90e9}
    for arch, want in expected.items():
        got = get_config(arch).total_params()
        assert abs(got - want) / want < 0.10, f"{arch}: {got / 1e9:.1f}B"


@pytest.mark.parametrize("arch", ["llama32_vision_90b", "seamless_m4t_v2"])
def test_serve_loop_skips_cross_layers_as_jax_does(arch):
    """``ServeLoop`` passes no memory, in JAX and here: cross layers are
    skipped.  The port's tokens equal JAX's loop's, and do not move when
    every cross weight is replaced."""
    cfg = get_smoke_config(arch)
    jm, jparams, tm = _pair(cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 6, 5)]
    jloop = JaxServeLoop(jm, jparams, slots=2, max_len=32)
    for i, p in enumerate(prompts):
        jloop.submit(JaxRequest(i, p, max_new_tokens=4))
    ref = {r.rid: list(r.out) for r in jloop.run()}

    def serve_port():
        loop = ServeLoop(tm, slots=2, max_len=32)
        for i, p in enumerate(prompts):
            loop.submit(Request(i, p, max_new_tokens=4))
        return {r.rid: list(r.out) for r in loop.run()}
    assert serve_port() == ref
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if ".cross." in name:
                p.normal_()
    assert serve_port() == ref


def test_serve_loop_refuses_jamba():
    m = _port_model(get_smoke_config("jamba_15_large"))
    with pytest.raises(ValueError, match="attention caches"):
        ServeLoop(m)


@pytest.mark.parametrize("arch", ["llama32_vision_90b", "seamless_m4t_v2"])
def test_greedy_decode_with_memory_tokens_equal_jax(arch):
    cfg = get_smoke_config(arch)
    jm, jparams, tm = _pair(cfg)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 5))
    fe = _frontend(cfg, seed=5) if cfg.frontend_tokens else None
    ref = jax_greedy_decode(jm, jparams, jnp.asarray(prompt, jnp.int32), 4,
                            None if fe is None else jnp.asarray(fe))
    got = serve.greedy_decode(tm, torch.from_numpy(prompt), 4,
                              None if fe is None else torch.from_numpy(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", _NEW_ARCHS)
def test_serve_main_on_cpu(arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "6",
                       "--tokens", "3"]) == 0


@pytest.mark.parametrize("arch,gb", [("jamba_15_large", 799), ("llama32_vision_90b", 181)])
def test_production_refuses_weights_larger_than_the_device(arch, gb, monkeypatch):
    """``--full-size`` (the full config served on the device; ``--production``
    until the dry run took that flag) checks the bf16 weights against the
    device's memory (80 GB: one H100) before it allocates anything."""
    monkeypatch.setattr(serve, "_device_memory_bytes", lambda device: 80 * 10**9)
    monkeypatch.setattr(serve, "LM", None)          # never reached
    need = get_config(arch).total_params() * 2
    with pytest.raises(ValueError, match=f"{need} bytes") as err:
        serve.main(["--arch", arch, "--full-size", "--device", "cpu"])
    assert f"({gb}." in str(err.value)
    serve.check_fits(get_config("seamless_m4t_v2"), torch.device("cpu"))
