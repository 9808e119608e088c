"""Port parity: the sliding window.

The JAX model masks a sliding window in its jnp scan
(``repro/models/attention.py``: key k kept for query q only if
``k > q - W``, independently of the causal mask); the Pallas kernel has
none.  The port's plain attention (``reference_attention``, the Hopper
kernels' plain version and oracle) takes the same window, in the kernels'
``[B*H, S, hd]`` layout, and the port's CPU ``gqa_attention`` keeps JAX's
scan.  Inputs are f32 from numpy seeds; the bar is 2e-5 (summation order,
as ``tests/test_kernels.py``), for outputs and gradients alike.  The
windowed work the bound and the dry run count (``kernels/cost.py``) is
held against a brute-force count of kept pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import cost, flash_attention, reference_attention
from repro_torch.models import attention as tattn

_TOL = 2e-5
_S = 37          # ragged: not a multiple of the scan's chunk of 16
_CHUNK = 16
_HEADS = {"mha": (4, 4), "gqa4": (8, 2)}


def _qkv(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (hq, hkv, hkv))


def _bhsd(x: np.ndarray) -> torch.Tensor:
    """[B, S, H, hd] -> the kernels' [B*H, S, hd]."""
    b, s, h, hd = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)))


def _windows(s):
    return [1, 12, s - 1, s, 2 * s]


@pytest.mark.parametrize("heads", sorted(_HEADS))
@pytest.mark.parametrize("window", _windows(_S))
@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_window_matches_jax(heads, window, causal):
    hq, hkv = _HEADS[heads]
    b, hd = 2, 16
    q, k, v = _qkv(b, _S, hq, hkv, hd, seed=window + 7 * causal)
    got = reference_attention(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                              sliding_window=window)
    ref = np.asarray(jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, chunk=_CHUNK, sliding_window=window))
    np.testing.assert_allclose(got.numpy(), _bhsd(ref).numpy(), atol=_TOL, rtol=_TOL)
    # the port's model-layout wrapper takes the same route on the CPU
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                          sliding_window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=_TOL, rtol=_TOL)


@pytest.mark.parametrize("heads", sorted(_HEADS))
@pytest.mark.parametrize("window", [1, 12, _S - 1])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_window_gradient_matches_jax_grad(heads, window, causal):
    """The gradient of sum(out * g) through the port's CPU route (the scan,
    each chunk checkpointed) against ``jax.grad`` of JAX's."""
    hq, hkv = _HEADS[heads]
    b, hd = 2, 16
    q, k, v = _qkv(b, _S, hq, hkv, hd, seed=100 + window)
    g = np.random.default_rng(window).standard_normal((b, _S, hq, hd)).astype(np.float32)

    def loss_jax(q, k, v):
        out = jattn.gqa_attention(q, k, v, causal=causal, chunk=_CHUNK, sliding_window=window)
        return (out * g).sum()

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.gqa_attention(*leaves, causal=causal, chunk=_CHUNK, sliding_window=window)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_TOL, rtol=_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_cost_counts_the_windows_kept_pairs(s, causal):
    """``attention_flops`` and ``bwd_flops`` count exactly the pairs the
    mask keeps: 4 hd FLOPs a pair forward, 2.5x that backward."""
    bh, hd = 3, 64
    pos = np.arange(s)
    for window in sorted({0, 1, 3, max(s - 1, 1), s, 2 * s}):
        keep = np.ones((s, s), bool)
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
        pairs = int(keep.sum())
        assert cost.attention_pairs(s, causal, window) == pairs, window
        assert cost.attention_flops(bh, s, hd, causal, window) == 4 * hd * pairs * bh
        assert cost.bwd_flops(bh, s, hd, causal, window) == 10 * hd * pairs * bh
        ms, by = cost.attention_bound_ms(bh, 1, s, hd, causal, "bf16", 2, window)
        assert by in ("operations", "bytes") and ms > 0


def test_mixtral_prefill_32k_window_work():
    """The windowed call of mixtral_8x7b's 32k prefill (32/8 heads of 128,
    W = 4096): 125.8 M kept pairs a head against 537.0 M causal, and a
    bound of 2.08 ms at the spec bf16 rate."""
    s, w = 32768, 4096
    assert cost.attention_pairs(s, True, w) == w * (w + 1) // 2 + (s - w) * w == 125_831_168
    assert cost.attention_pairs(s, True) == 536_887_296
    ms, by = cost.attention_bound_ms(32, 8, s, 128, True, "bf16", 2, w)
    assert by == "operations" and abs(ms - 2.0845) < 1e-3


def _recorded(fn):
    from repro_torch.kernels import cost as cost_mod
    seen = []
    sink = lambda *rec: seen.append(rec)  # noqa: E731
    cost_mod.add_sink(sink)
    try:
        return fn(), seen
    finally:
        cost_mod.remove_sink(sink)


@pytest.mark.parametrize("dtype,hd,variant", [(torch.bfloat16, 128, "wgmma"),
                                              (torch.float32, 64, "cuda_core")])
@pytest.mark.parametrize("causal", [True, False])
def test_window_meta_branch_records_the_kept_pairs(dtype, hd, variant, causal):
    """Meta tensors (the dry run) with a window take the kernels' meta
    branches, forward and backward: the windowed FLOPs are recorded, the
    launch counts do not move."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    bh, bh_kv, s, window = 8, 2, 48, 10
    meta = [torch.empty(n, s, hd, dtype=dtype, device="meta").requires_grad_()
            for n in (bh, bh_kv, bh_kv)]
    fa.reset_launch_counts()
    o, seen = _recorded(lambda: fa.flash_attention_bhsd(*meta, causal=causal,
                                                        sliding_window=window))
    rate = "bf16" if variant == "wgmma" else "f32"
    esize = torch.empty(0, dtype=dtype).element_size()
    assert seen == [(f"flash_attention_bhsd[{variant}]",
                     cost.attention_flops(bh, s, hd, causal, window),
                     cost.attention_bytes(bh, bh_kv, s, hd, esize), rate)]
    _, seen = _recorded(lambda: torch.autograd.grad(o, meta, torch.empty_like(o)))
    assert seen == [(f"flash_attention_bwd[{fa.backward_variant(dtype, hd)}]",
                     cost.bwd_flops(bh, s, hd, causal, window),
                     cost.bwd_bytes(bh, bh_kv, s, hd, esize), rate)]
    assert cost.attention_flops(bh, s, hd, causal, window) < cost.attention_flops(
        bh, s, hd, causal)
    assert fa.flash_attention_bhsd.launches == 0 and fa.flash_attention_bhsd.mask_launches == {}


def test_mixtral_prefill_32k_dry_run_cell_is_ok():
    """The cell that errored before the windowed kernels: mixtral_8x7b's
    ``prefill_32k`` on the 16 x 16 production mesh builds, with one
    windowed launch a layer a rank and the windowed work in its FLOPs."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    assert not dist.is_initialized()
    cell = dryrun.run_cell("mixtral_8x7b", "prefill_32k", multi_pod=False, verbose=False)
    assert not dist.is_initialized()
    assert cell["status"] == "ok" and cell["mesh"] == "16x16", cell.get("error")
    assert cell["kernel_launches"] == {"flash_attention_bhsd[wgmma]": 32}
    assert cell["fits_hbm"] and cell["dominant"] in ("compute", "memory", "collective")
