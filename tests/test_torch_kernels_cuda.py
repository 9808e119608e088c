"""The Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (a CUDA kernel has no CPU
form) and skip without one.  The file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (atol, rtol), those of ``chip_smoke.py``: flash f32 2e-5
for summation order, as ``tests/test_kernels.py``; flash bf16 1e-5 and
2**-7, because kernel and plain version both compute in f32 and round
once to bf16, so they differ by at most one bf16 ulp of the output.  The
tensor-core kernel (bf16 at hd 64 and 128) is held to the same bf16
limit: it splits p into two bf16 halves, so its P.V keeps the f32 p.
WKV out: rtol 1e-5 in f32 and 2**-7 in bf16 on the same grounds, and an
atol of 2e-4 in both, 20 standard deviations of the f32 difference
between two summation orders of the 64 products r_i (S_ij + u_i k_i v_j),
whose partial sums reach about 25 once the state is in steady state.
The WKV state is f32 in every case and has no sum: 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention_bhsd, flash_attention_bhsd_plain,
                                 rwkv_wkv, wkv_bhsd, wkv_bhsd_plain)
from repro_torch.kernels.flash_attention import kernel_variant

_SHAPES = [
    (1, 32, 2, 2, 16),      # MHA
    (2, 64, 4, 2, 32),      # GQA 2:1
    (1, 128, 8, 1, 64),     # MQA
    (2, 48, 4, 4, 128),     # S not a multiple of the tile
    (1, 1000, 4, 2, 128),   # ragged S over several tiles
    # the tensor-core kernel's 128-row q and K/V tiles: one row, one short
    # of a tile, one past it, many tiles; GQA 4:1 at both of its head dims
    (1, 1, 4, 1, 128),
    (1, 127, 4, 1, 128),
    (1, 129, 4, 1, 128),
    (1, 4096, 4, 1, 128),
    (2, 300, 8, 2, 64),
    (2, 300, 8, 2, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    # the plain version runs f32 matmuls: keep them in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd", _SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(card, b, s, h, hkv, hd, dtype, causal):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(b * s + h)
    q, k, v = (torch.randn((b * n, s, hd), generator=gen, device=card).to(tdt)
               for n in (h, hkv, hkv))
    before = flash_attention_bhsd.launches
    out = flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    assert out.dtype == tdt and out.shape == q.shape
    ref = flash_attention_bhsd_plain(q, k, v, causal=causal)
    atol, rtol = (2e-5, 2e-5) if dtype == "f32" else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,variant", [
    ("bf16", 64, "wgmma"), ("bf16", 128, "wgmma"),
    ("bf16", 16, "cuda_core"), ("bf16", 32, "cuda_core"),
    ("f32", 64, "cuda_core"), ("f32", 128, "cuda_core")])
def test_flash_kernel_variant_counts(card, dtype, hd, variant):
    """bf16 at hd 64 and 128 launches the tensor-core kernel, every other
    call the CUDA-core one; each raises its own count and the sum."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    assert kernel_variant(tdt, hd) == variant
    q = torch.randn(8, 200, hd, device=card).to(tdt)
    kv = torch.randn(2, 200, hd, device=card).to(tdt)
    total = flash_attention_bhsd.launches
    counts = dict(flash_attention_bhsd.variant_launches)
    flash_attention_bhsd(q, kv, kv, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == total + 1
    want = {name: n + (name == variant) for name, n in counts.items()}
    assert flash_attention_bhsd.variant_launches == want


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(4, 8, 128, device=card)
    before = flash_attention_bhsd.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bhsd(q[..., :96].contiguous(), q[:2, :, :96].contiguous(),
                             q[:2, :, :96].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_bhsd(q.half(), q[:2].half(), q[:2].half())
    with pytest.raises(ValueError, match="contiguous"):
        kt = torch.zeros(2, 128, 8, device=card).transpose(1, 2)
        flash_attention_bhsd(q, kt, kt)
    # TMA reads from 16-byte-aligned bases: a contiguous view one element
    # into its storage is refused, not handed to the other kernel
    flat = torch.zeros(4 * 8 * 128 + 1, device=card, dtype=torch.bfloat16)
    qm = flat[1:].view(4, 8, 128)
    assert qm.is_contiguous() and qm.data_ptr() % 16
    kb = torch.zeros(2, 8, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_bhsd(qm, kb, kb)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_bhsd(kb.repeat(2, 1, 1), qm[:2], kb)
    assert flash_attention_bhsd.launches == before     # nothing launched, nothing fell back


# WKV: (b, s, h, hd) — tests/test_kernels.py::TestRwkvWkv's shapes and a
# ragged S over the model's heads
_WKV_SHAPES = [(1, 16, 1, 8), (2, 32, 2, 16), (1, 64, 4, 64), (2, 24, 2, 32),
               (1, 300, 32, 64)]
_WKV_TOL = {"f32": (2e-4, 1e-5), "bf16": (2e-4, 2.0 ** -7)}
_STATE_TOL = (1e-5, 1e-5)


def _wkv_inputs(b, s, h, hd, dtype, w_law, seed, device):
    """r/k/v/w [B,H,S,hd], u [H,hd], s0 [B,H,hd,hd] f32, from numpy.

    w is drawn per element, so a state transposed between key and value
    axes would fail.  ``dtype`` "bf16" gives bf16 r/k/v/u with f32 w (the
    model's mix), "bf16w" bf16 w as well."""
    rng = np.random.default_rng(seed)
    shape = (b, h, s, hd)
    r, k, v = (rng.normal(size=shape) for _ in range(3))
    if w_law == "uniform":
        w = rng.uniform(0.2, 0.95, size=shape)
    else:       # the model's law: exp(-min(exp(N(0,1)), 8))
        w = np.exp(-np.minimum(np.exp(rng.normal(size=shape)), 8.0))
    u = rng.normal(size=(h, hd))
    s0 = rng.normal(size=(b, h, hd, hd))
    io = torch.float32 if dtype == "f32" else torch.bfloat16
    wt = torch.bfloat16 if dtype == "bf16w" else torch.float32
    t = lambda a, dt: torch.tensor(a, dtype=torch.float32, device=device).to(dt)  # noqa: E731
    return (t(r, io), t(k, io), t(v, io), t(w, wt), t(u, io),
            t(s0, torch.float32))


def _close(out, ref, tol):
    atol, rtol = tol
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", _WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16w"])
@pytest.mark.parametrize("w_law", ["uniform", "model"])
def test_wkv_kernel_matches_plain(card, b, s, h, hd, dtype, w_law):
    args = _wkv_inputs(b, s, h, hd, dtype, w_law, b * s + hd, card)
    before = wkv_bhsd.launches
    out, sT = wkv_bhsd(*args)
    torch.cuda.synchronize()
    assert wkv_bhsd.launches == before + 1
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert sT.dtype == torch.float32 and sT.shape == args[5].shape
    ref, sT_ref = wkv_bhsd_plain(*args)
    _close(out, ref, _WKV_TOL["f32" if dtype == "f32" else "bf16"])
    _close(sT, sT_ref, _STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_kernel_state_passing_equals_one_call(card, dtype):
    """Two calls with the state carried across equal one call, and S=1
    steps (decode) equal it too."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 64, 4, 64, dtype, "model", 7, card)
    out, sT = wkv_bhsd(r, k, v, w, u, s0)
    o1, s_mid = wkv_bhsd(r[:, :, :40].contiguous(), k[:, :, :40].contiguous(),
                         v[:, :, :40].contiguous(), w[:, :, :40].contiguous(), u, s0)
    o2, s_end = wkv_bhsd(r[:, :, 40:].contiguous(), k[:, :, 40:].contiguous(),
                         v[:, :, 40:].contiguous(), w[:, :, 40:].contiguous(), u, s_mid)
    assert torch.equal(torch.cat([o1, o2], dim=2), out) and torch.equal(s_end, sT)
    state, steps = s0, []
    for t in range(r.shape[2]):
        o, state = wkv_bhsd(*(x[:, :, t:t + 1].contiguous() for x in (r, k, v, w)),
                            u, state)
        steps.append(o)
    assert torch.equal(torch.cat(steps, dim=2), out) and torch.equal(state, sT)


@pytest.mark.cuda
def test_rwkv_wkv_model_layout_on_the_card(card):
    """ops.rwkv_wkv in [B,S,H,hd] at B=1 (a strided transpose) with s0=None."""
    r, k, v, w, u, _ = _wkv_inputs(1, 33, 4, 64, "bf16", "model", 3, card)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    before = wkv_bhsd.launches
    out, sT = rwkv_wkv(tr(r), tr(k), tr(v), tr(w), u)
    assert wkv_bhsd.launches == before + 1
    ref, sT_ref = wkv_bhsd_plain(r, k, v, w, u, torch.zeros_like(sT))
    _close(out, tr(ref), _WKV_TOL["bf16"])
    _close(sT, sT_ref, _STATE_TOL)


@pytest.mark.cuda
def test_wkv_kernel_rejects_what_it_does_not_take(card):
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 2, 64, "f32", "uniform", 0, card)
    before = wkv_bhsd.launches
    with pytest.raises(ValueError, match="head_dim"):
        wkv_bhsd(*(x[..., :48].contiguous() for x in (r, k, v, w)), u[:, :48].contiguous(),
                 s0[..., :48, :48].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wkv_bhsd(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wkv_bhsd(r, k, v, w.double(), u, s0)
    with pytest.raises(ValueError, match="float32 s0"):
        wkv_bhsd(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        wkv_bhsd(torch.cat([r, r], dim=3)[..., ::2], k, v, w, u, s0)
    with pytest.raises(ValueError, match="S >= 1"):
        wkv_bhsd(*(x[:, :, :0] for x in (r, k, v, w)), u, s0)
    with pytest.raises(ValueError, match="CUDA device or all"):
        wkv_bhsd(r, k, v, w.cpu(), u, s0)
    assert wkv_bhsd.launches == before     # nothing launched, nothing fell back
