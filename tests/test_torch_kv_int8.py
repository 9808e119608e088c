"""Port parity: the int8 KV cache (``LM(kv_dtype="int8")``) against JAX's.

f32 on the CPU, from one numpy seed.  ``_quantize_kv`` gives JAX's int8
values and bf16 scales bit for bit, exact ties (x / scale = n + 0.5,
rounded half to even) included.  Decoding the smoke ``llama3_8b``
through the int8 cache: the scales equal JAX's, and an int8 entry may
differ by 1 where the port's k or v (its matmuls sum in another order,
about 1e-6 apart) lands on the other side of a rounding boundary; the
test counts those among the written entries and allows at most 1 in
1000 (none were seen).  Logits agree with JAX's to 1e-4, the bar of
``tests/test_torch_lm.py`` (1.9e-6 seen).  The bar of
``tests/test_archs_smoke.py::test_int8_kv_cache_decode`` holds too:
within 5 % of the bf16-cache logits (here the forward's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models.transformer import _quantize_kv as jax_quantize_kv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import load_jax_params
from repro_torch.models import LM
from repro_torch.models.transformer import _quantize_kv

_LOGIT_TOL = 1e-4
_MAX_OFF_BY_ONE = 1e-3          # share of int8 entries allowed to differ by 1


def _ties() -> np.ndarray:
    """[1, 2, 2, 8] rows whose absmax is 127 * 2**-e, so scale = 2**-e
    exactly and x / scale hits every kind of half-way point."""
    base = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.0])
    rows = [base * 2.0 ** -e for e in (0, 3, 7, -2)]
    return np.stack(rows).reshape(1, 2, 2, 8).astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "normal", "tiny", "zeros"])
def test_quantize_kv_matches_jax(case):
    rng = np.random.default_rng(3)
    x = {"ties": _ties(),
         "normal": rng.normal(size=(2, 1, 4, 16)).astype(np.float32),
         # absmax / 127 below the 1e-8 floor
         "tiny": (rng.normal(size=(2, 1, 4, 16)) * 1e-9).astype(np.float32),
         "zeros": np.zeros((2, 1, 4, 16), np.float32)}[case]
    q, s = _quantize_kv(torch.from_numpy(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert s.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js).astype(np.float32))
    if case == "ties":     # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -126.5 -> -126
        assert q[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -126, 3]


def _models():
    cfg = get_smoke_config("llama3_8b")
    kw = dict(param_dtype=jnp.float32, attn_chunk=8, max_seq=32)
    jcfg = jax_smoke_config("llama3_8b")
    jm, jq = JaxLM(jcfg, **kw), JaxLM(jcfg, kv_dtype="int8", **kw)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8,
            max_seq=32, kv_dtype="int8", device="cpu")
    load_jax_params(tm, tree)
    return cfg, jm, jq, jax.tree.map(jnp.asarray, tree), tm


def test_int8_decode_matches_jax():
    cfg, jm, jq, params, tm = _models()
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    jcache = jq.init_cache(2, 32, dtype=jnp.float32)
    tcache = tm.init_cache(2, 32, dtype=torch.float32)
    assert [set(c) for c in tcache] == [set(c) for c in jcache]
    step = jax.jit(jq.decode_step)
    n = tokens.shape[1]
    worst = 0.0
    with torch.no_grad():
        for t in range(n):
            jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]), t)
            tl, tcache = tm.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]), t)
            worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert worst < _LOGIT_TOL, worst
    off, total = 0, 0
    for tc, jc in zip(tcache, jcache):
        for name in ("k", "v"):
            assert tc[name].dtype == torch.int8
            assert tc[f"{name}_scale"].dtype == torch.bfloat16
            np.testing.assert_array_equal(tc[f"{name}_scale"].float().numpy(),
                                          np.asarray(jc[f"{name}_scale"]).astype(np.float32))
            # [n_rep, B, max_len, Hkv, hd]: the written positions
            diff = np.abs(tc[name][:, :, :n].numpy().astype(np.int32)
                          - np.asarray(jc[name])[:, :, :n].astype(np.int32))
            assert diff.max() <= 1, name
            off += int((diff == 1).sum())
            total += diff.size
    assert off <= _MAX_OFF_BY_ONE * total, (off, total)


def test_int8_decode_within_five_percent_of_bf16():
    """tests/test_archs_smoke.py::test_int8_kv_cache_decode's llama3_8b
    case, on the port: int8 decode logits against the forward's."""
    cfg, *_, tm = _models()
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        ref = tm(tokens)
        cache = tm.init_cache(2, 32, dtype=torch.float32)
        worst = 0.0
        for t in range(tokens.shape[1]):
            logits, cache = tm.decode_step(cache, tokens[:, t:t + 1], t)
            worst = max(worst, float((logits[:, 0] - ref[:, t]).abs().max()))
    assert worst / float(ref.abs().max()) < 0.05
    assert cache[0]["k"].dtype == torch.int8 and cache[0]["v"].dtype == torch.int8


def test_default_cache_is_unquantized():
    cfg = get_smoke_config("llama3_8b")
    for kv_dtype in ("bf16", "anything else"):
        m = LM(cfg, param_dtype=torch.float32, kv_dtype=kv_dtype, device="cpu")
        cache = m.init_cache(2, 8, dtype=torch.float32)
        assert set(cache[0]) == {"k", "v"} and cache[0]["k"].dtype == torch.float32
