"""Port parity: the training loss and its gradients, against
``jax.value_and_grad(LM.loss)`` on weights carried from JAX ``LM.init``.

f32 on the CPU, where attention is the chunked scan, RWKV the chunked
WKV and Mamba the chunked selective scan (4-step chunks), the JAX model's
own numerics; archs with a frontend get seeded frontend embeddings in the
batch.  Tolerances: the loss to 1e-5
absolute (about 2e-6 of its value, ln V ~ 6); every gradient leaf to
atol 5e-5 and rtol 1e-4.  Both sides run the same graph in f32 and sum
in other orders; the largest difference seen is 1e-5 (rwkv6_1b6, whose
chunked WKV also orders its chunk sums otherwise), against leaves whose
largest entries are 0.3-1.6.  The MoE archs run at the default capacity
factor of 1.25, where the smoke configs drop tokens; their loss carries
0.01 of the summed load-balancing loss.  The port's ``remat="full"`` and
``"dots"`` recompute the same operations on the same inputs, so they
equal ``"none"`` exactly, the Mamba chunks' and the attention scan's
own checkpoints nested inside (jamba, seamless's encoder).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as JaxLM
from repro_torch.configs import get_smoke_config
from repro_torch.convert import flatten_tree, load_jax_params, param_tree, tree_map
from repro_torch.models import LM
from repro_torch.models import transformer as transformer_mod

_ARCHS = ["llama3_8b", "granite_8b", "minitron_4b", "qwen25_32b", "rwkv6_1b6",
          "olmoe_1b_7b", "mixtral_8x7b", "jamba_15_large", "llama32_vision_90b",
          "seamless_m4t_v2"]
_LOSS_TOL = dict(atol=1e-5, rtol=0.0)
_GRAD_TOL = dict(atol=5e-5, rtol=1e-4)


def _pair(arch, remat="none"):
    cfg = get_smoke_config(arch)
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=8, rwkv_chunk=4, mamba_chunk=4)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8, rwkv_chunk=4, mamba_chunk=4,
            remat=remat, device="cpu")
    load_jax_params(tm, tree)
    for p in tm.parameters():
        p.requires_grad_(True)
    return cfg, jm, tree, tm


def _batch(cfg, bsz=2, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (bsz, seq + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if cfg.frontend_tokens:
        batch["frontend"] = rng.normal(
            size=(bsz, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _jax_loss_grads(jm, tree, batch, vocab_chunk):
    loss, grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()},
        vocab_chunk=vocab_chunk)
    return float(loss), flatten_tree(jax.tree.map(np.asarray, grads))


def _port_loss_grads(tm, batch, vocab_chunk):
    for p in tm.parameters():
        p.grad = None
    loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                   vocab_chunk=vocab_chunk)
    loss.backward()
    grads = flatten_tree(tree_map(lambda p: p.grad.numpy().copy(), param_tree(tm)))
    return loss.detach(), grads


def _assert_grads_close(grads, ref):
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref[name], err_msg=name, **_GRAD_TOL)


@pytest.mark.parametrize("arch", _ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    cfg, jm, tree, tm = _pair(arch)
    batch = _batch(cfg)
    ref_loss, ref_grads = _jax_loss_grads(jm, tree, batch, vocab_chunk=8)
    loss, grads = _port_loss_grads(tm, batch, vocab_chunk=8)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), ref_loss, **_LOSS_TOL)
    _assert_grads_close(grads, ref_grads)


def _rules_batch(cfg, case):
    batch = _batch(cfg, seed=2)
    rng = np.random.default_rng(3)
    if case == "mask":
        batch["mask"] = (rng.uniform(size=batch["labels"].shape) < 0.6).astype(np.float32)
    elif case == "zero_mask":            # the divisor is at least 1
        batch["mask"] = np.zeros(batch["labels"].shape, np.float32)
    elif case == "labels_out_of_range":  # one_hot rows of zeros
        labels = batch["labels"].copy()
        labels[0, 3], labels[1, 7], labels[1, 0] = -1, cfg.vocab_size, cfg.vocab_size + 5
        batch["labels"] = labels
    return batch


@pytest.mark.parametrize("case,vocab_chunk", [
    ("plain", 5),                   # 5 does not divide S = 16: one chunk of 16
    ("plain", 16),                  # one chunk, exactly
    ("plain", 64),                  # longer than S: one chunk of S
    ("mask", 4),
    ("zero_mask", 8),
    ("labels_out_of_range", 8),
])
def test_loss_rules_match_jax(case, vocab_chunk):
    cfg, jm, tree, tm = _pair("llama3_8b")
    batch = _rules_batch(cfg, case)
    ref_loss, ref_grads = _jax_loss_grads(jm, tree, batch, vocab_chunk)
    loss, grads = _port_loss_grads(tm, batch, vocab_chunk)
    np.testing.assert_allclose(float(loss), ref_loss, **_LOSS_TOL)
    _assert_grads_close(grads, ref_grads)
    if case == "zero_mask":
        assert float(loss) == 0.0


def _assert_remat_equals_none(arch, remat):
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, seed=4)
    out = []
    for policy in ("none", remat):
        *_, tm = _pair(arch, remat=policy)
        out.append(_port_loss_grads(tm, batch, vocab_chunk=8))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert torch.equal(loss_a, loss_b)
    for name, g in grads_a.items():
        np.testing.assert_array_equal(g, grads_b[name], err_msg=name)


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_1b6", "olmoe_1b_7b",
                                  "jamba_15_large", "seamless_m4t_v2"])
def test_remat_full_equals_none(arch):
    _assert_remat_equals_none(arch, "full")


@pytest.mark.parametrize("arch", ["llama3_8b", "rwkv6_1b6", "olmoe_1b_7b",
                                  "jamba_15_large", "seamless_m4t_v2"])
def test_remat_dots_equals_none(arch):
    _assert_remat_equals_none(arch, "dots")


@pytest.mark.parametrize("arch,saved", [
    ("llama3_8b", 7),     # wq, wk, wv, wo, w_gate, w_up, w_down
    ("olmoe_1b_7b", 5),   # wq, wk, wv, wo, router; the expert products are bmm
])
def test_remat_dots_saves_the_products_without_batch_dims(arch, saved, monkeypatch):
    """Under "dots" the layer forward saves exactly its ``x @ W`` products
    (``aten.mm``): the attention and MoE expert products, which have batch
    dims, are recomputed with the rest."""
    decided, policy_fn = [], transformer_mod._save_dots

    def recording(ctx, op, *args, **kwargs):
        policy = policy_fn(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decided.append((op, policy))
        return policy
    monkeypatch.setattr(transformer_mod, "_save_dots", recording)
    cfg, *_, tm = _pair(arch, remat="dots")
    loss, _ = _port_loss_grads(tm, _batch(cfg, seed=5), vocab_chunk=8)
    kept = [op for op, policy in decided if policy == transformer_mod.CheckpointPolicy.MUST_SAVE]
    assert set(kept) == {torch.ops.aten.mm.default}
    assert len(kept) == saved * cfg.n_layers
    assert torch.ops.aten.bmm.default in {op for op, _ in decided}
    assert bool(torch.isfinite(loss))


def test_loss_without_grad_builds_no_graph():
    """Serving-style calls: the parameters do not require grad by default,
    and under no_grad the loss is a plain number with no checkpoints."""
    cfg = get_smoke_config("llama3_8b")
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=8, device="cpu")
    assert not any(p.requires_grad for p in tm.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss = tm.loss(batch)
    assert loss.grad_fn is None and bool(torch.isfinite(loss))
    with torch.no_grad():
        assert torch.equal(tm.loss(batch), loss)


@pytest.mark.parametrize("remat,error", [("some", ValueError)])
def test_unported_remat_policies_raise(remat, error):
    with pytest.raises(error, match="remat"):
        LM(get_smoke_config("llama3_8b"), param_dtype=torch.float32, remat=remat,
           device="cpu")
