"""Port parity: continuous-batching ``ServeLoop`` and the serve launcher.

The port's loop, on weights carried from JAX ``LM.init``, must emit
exactly the JAX loop's tokens (greedy argmax over f32 logits that agree
to 1e-4), and keep the JAX loop's own invariants.  The MoE archs take the
same loop: their decode step routes each slot's token on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as JaxLM
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_smoke_config
from repro_torch.convert import load_jax_params
from repro_torch.launch import serve
from repro_torch.models import LM, LayerSpec
from repro_torch.runtime import Request, ServeLoop


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config("llama3_8b")
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=8, max_seq=64)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8, max_seq=64,
            device="cpu")
    load_jax_params(tm, tree)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm


def _serve(model, requests, slots):
    loop = ServeLoop(model, slots=slots, max_len=48)
    for r in requests:
        loop.submit(r)
    return {r.rid: list(r.out) for r in loop.run()}


def _prompts(cfg, seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in sizes]


def test_tokens_equal_jax_serve_loop(models):
    cfg, jm, jparams, tm = models
    prompts = _prompts(cfg, 0, (3, 7, 5, 4, 6))
    jloop = JaxServeLoop(jm, jparams, slots=2, max_len=48)
    for i, p in enumerate(prompts):
        jloop.submit(JaxRequest(i, p, max_new_tokens=6))
    ref = {r.rid: list(r.out) for r in jloop.run()}
    got = _serve(tm, [Request(i, p, max_new_tokens=6)
                      for i, p in enumerate(prompts)], slots=2)
    assert got == ref


def test_concurrent_equals_solo(models):
    cfg, _, _, tm = models
    prompts = _prompts(cfg, 0, (3, 7, 5, 4, 6))
    reqs = lambda: [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]  # noqa: E731
    solo = {}
    for r in reqs():
        solo.update(_serve(tm, [r], slots=2))
    assert _serve(tm, reqs(), slots=2) == solo


def test_more_requests_than_slots_all_finish(models):
    cfg, _, _, tm = models
    requests = [Request(i, p, max_new_tokens=4)
                for i, p in enumerate(_prompts(cfg, 1, [4] * 7))]
    done = _serve(tm, requests, slots=3)
    assert len(done) == 7 and all(len(v) == 4 for v in done.values())


def test_eos_stops_early(models):
    cfg, _, _, tm = models
    prompt = _prompts(cfg, 2, [4])[0]
    first = _serve(tm, [Request(0, prompt, max_new_tokens=3)], slots=1)[0][0]
    loop = ServeLoop(tm, slots=1, max_len=48)
    loop.submit(Request(1, prompt, max_new_tokens=8, eos_id=first))
    done = loop.run()
    assert len(done) == 1 and done[0].out[-1] == first
    assert len(done[0].out) <= 8


def test_stateful_arch_rejected(models):
    *_, tm = models
    stateful = LM(get_smoke_config("llama3_8b"), param_dtype=torch.float32,
                  device="cpu")
    stateful.specs = [LayerSpec("rwkv", False, False)]
    with pytest.raises(ValueError, match="attention caches"):
        ServeLoop(stateful)


def test_greedy_decode_tokens_equal_jax(models):
    from repro.launch.serve import greedy_decode as jax_greedy_decode
    cfg, jm, jparams, tm = models
    prompt = np.stack(_prompts(cfg, 3, (5, 5)))
    ref = jax_greedy_decode(jm, jparams, jnp.asarray(prompt), 4)
    got = serve.greedy_decode(tm, torch.from_numpy(prompt).long(), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_serve_main_on_cpu():
    assert serve.main(["--arch", "llama3_8b", "--device", "cpu",
                       "--prompt-len", "6", "--tokens", "4"]) == 0


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x7b"])
def test_moe_serve_loop_tokens_equal_jax(arch):
    cfg = get_smoke_config(arch)
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=8, max_seq=64)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8, max_seq=64, device="cpu")
    load_jax_params(tm, tree)
    prompts = _prompts(cfg, 4, (3, 6, 5))
    jloop = JaxServeLoop(jm, jax.tree.map(jnp.asarray, tree), slots=2, max_len=48)
    for i, p in enumerate(prompts):
        jloop.submit(JaxRequest(i, p, max_new_tokens=5))
    ref = {r.rid: list(r.out) for r in jloop.run()}
    got = _serve(tm, [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)],
                 slots=2)
    assert got == ref and all(len(v) == 5 for v in got.values())


def test_serve_main_moe_on_cpu():
    assert serve.main(["--arch", "olmoe_1b_7b", "--device", "cpu",
                       "--prompt-len", "6", "--tokens", "4"]) == 0
