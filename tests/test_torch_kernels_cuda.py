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
The WKV state is f32 in every case: 1e-5.  The WKV backward kernel is
held against autograd of the plain version: every gradient within
``_WKV_BWD_REL`` of its largest magnitude (f32, the limit that
tests/test_torch_wkv_bwd.py derives from the f64 oracle), plus one bf16
ulp (rtol 2**-7) where the gradient is bf16.  The flash backward kernel is
held against autograd of the plain version at the forward's limits (see
``_BWD_SHAPES``).  The sequential WKV kernel
updates it one step at a time; the chunked one sums 16 steps' updates
from bf16 parts of k*E that keep f32 precision, which
tests/test_torch_wkv_numerics.py rehearses at the same limit.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, flash_attention_bhsd,
                                 flash_attention_bhsd_plain, rwkv_wkv, wkv_bhsd,
                                 wkv_bhsd_plain)
from repro_torch.kernels.flash_attention import backward_variant, kernel_variant
from repro_torch.models import attention as attention_mod
from repro_torch.models.moe import moe_ffn, moe_route

# the modules: the package's ``flash_attention`` and ``rwkv_wkv`` are the
# model-layout functions
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
wkvk = importlib.import_module("repro_torch.kernels.rwkv_wkv")

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
    (1, 4096, 16, 16, 128),  # olmoe_1b_7b's MHA at its training length
    (1, 4096, 64, 8, 128),   # jamba_15_large's and llama32_vision_90b's GQA 8:1
    (1, 4096, 16, 16, 64),   # seamless_m4t_v2's MHA at hd 64 (its encoder is non-causal)
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
def test_flash_kernel_counts_launches_by_mask(card):
    """The causal and the full mask are counted apart, for the forward
    and the backward kernels (seamless_m4t_v2's encoder is non-causal)."""
    fa_mod.reset_launch_counts()
    q = torch.randn(16, 300, 64, device=card).bfloat16().requires_grad_()
    kv = torch.randn(16, 300, 64, device=card).bfloat16()
    with torch.no_grad():
        flash_attention_bhsd(q, kv, kv, causal=True)
    flash_attention_bhsd(q, kv, kv, causal=False).sum().backward()
    torch.cuda.synchronize()
    assert flash_attention_bhsd.mask_launches == {
        "wgmma/causal": 1, "wgmma/full": 1, "backward_wgmma/full": 1}
    assert flash_attention_bhsd.launches == 3


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


# The backward kernel: S=1, MHA, GQA, MQA, S off the 64-row tile, ragged S
# over many tiles, both head dims of the tensor-core forward.  Limits: f32
# 2e-5, as the forward (summation order); bf16 atol 1e-5 and rtol 2**-7:
# kernel and autograd of the plain version both compute the gradients in
# f32 from the same bf16 inputs and round once to bf16 (the kernel sums D
# from p * dP, as autograd's softmax backward does, not from the rounded o).
_BWD_SHAPES = [(1, 1, 4, 1, 128), (1, 32, 2, 2, 16), (2, 64, 4, 2, 32),
               (1, 128, 8, 1, 64), (2, 48, 4, 4, 128), (1, 1000, 4, 2, 128),
               (2, 300, 8, 2, 64)]


def _grads(fn, q, k, v, do, causal):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, causal=causal)
    return out, torch.autograd.grad(out, leaves, do)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd", _BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_autograd_of_plain(card, b, s, h, hkv, hd, dtype, causal):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(7 * s + hd)
    q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device=card).to(tdt)
                   for n in (h, hkv, hkv, h))
    counts = dict(flash_attention_bhsd.variant_launches)
    out, grads = _grads(flash_attention_bhsd, q, k, v, do, causal)
    torch.cuda.synchronize()
    launched = (kernel_variant(tdt, hd), backward_variant(tdt, hd))
    want = {name: n + (name in launched) for name, n in counts.items()}
    assert flash_attention_bhsd.variant_launches == want
    # the forward under grad (lse written) returns what serving's does
    with torch.no_grad():
        assert torch.equal(out, flash_attention_bhsd(q, k, v, causal=causal))
    _, ref = _grads(flash_attention_bhsd_plain, q, k, v, do, causal)
    atol, rtol = (2e-5, 2e-5) if dtype == "f32" else (1e-5, 2.0 ** -7)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == tdt and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("f32", 64), ("bf16", 64), ("bf16", 128), ("bf16", 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_lse_is_the_rows_logsumexp(card, dtype, hd, causal):
    """Both forward kernels' lse output, in natural-log units, against
    logsumexp of the plain version's scaled, masked f32 scores."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(hd)
    s = 300
    q, k, v = (torch.randn((n, s, hd), generator=gen, device=card).to(tdt) for n in (8, 2, 2))
    _, lse = fa_mod._forward(q, k, v, causal, with_lse=True)
    scores = (q.float().reshape(2, 4, s, hd) * hd ** -0.5) @ k.float()[:, None].transpose(-1, -2)
    if causal:
        scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=card).tril(),
                                    float("-inf"))
    ref = torch.logsumexp(scores, dim=-1).reshape(8, s)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_backward_is_deterministic_and_reaches_model_layout(card):
    """Two identical backward calls give bit-identical gradients (no
    atomics), and grads reach q, k and v through ops.flash_attention's
    layout copies."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((2, 200, 8, 128), generator=gen, device=card).bfloat16()
    k, v = (torch.randn((2, 200, 2, 128), generator=gen, device=card).bfloat16()
            for _ in range(2))
    do = torch.randn_like(q)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        runs.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


@pytest.mark.cuda
def test_flash_backward_rejects_what_it_does_not_take(card):
    q = torch.randn(4, 8, 128, device=card)
    kv = torch.randn(2, 8, 128, device=card)
    lse = torch.zeros(4, 8, device=card)
    before = flash_attention_bhsd.launches
    with pytest.raises(ValueError, match="dO"):
        fa_mod.flash_attention_bwd(q, kv, kv, lse, q.bfloat16())
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bwd(q, kv, kv, lse.bfloat16(), q)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(4, 8, 96, device=card, requires_grad=True)
        flash_attention_bhsd(x, kv[..., :96].contiguous(), kv[..., :96].contiguous())
    assert flash_attention_bhsd.launches == before


# The tensor-core backward: its 128-row dQ tiles and 128-key dK/dV blocks
# with 64-row q steps, one row, one short of and one past each, ragged S
# over many tiles, GQA 4:1 at both head dims, and the training shapes'
# heads at S=4096 (llama3_8b's GQA 32/8, olmoe_1b_7b's MHA 16/16 at hd 128,
# seamless_m4t_v2's at hd 64).
_WGMMA_BWD_SHAPES = [(1, 1, 4, 1, 128), (1, 63, 4, 1, 64), (1, 65, 4, 1, 128),
                     (1, 127, 4, 1, 64), (1, 129, 4, 1, 128), (2, 300, 8, 2, 64),
                     (1, 1000, 8, 2, 128), (1, 1000, 16, 4, 64), (1, 4096, 32, 8, 128),
                     (1, 4096, 16, 16, 128), (1, 4096, 16, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,variant", [
    ("bf16", 64, "backward_wgmma"), ("bf16", 128, "backward_wgmma"),
    ("bf16", 16, "backward"), ("bf16", 32, "backward"),
    ("f32", 64, "backward"), ("f32", 128, "backward")])
def test_flash_backward_variant_counts(card, dtype, hd, variant):
    """The tensor-core backward serves exactly the calls whose forward is
    the tensor-core kernel; each backward raises its own count and the sum."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    assert backward_variant(tdt, hd) == variant
    q = torch.randn(8, 200, hd, device=card).to(tdt).requires_grad_()
    kv = torch.randn(2, 200, hd, device=card).to(tdt).requires_grad_()
    out = flash_attention_bhsd(q, kv, kv, causal=True)
    total = flash_attention_bhsd.launches
    counts = dict(flash_attention_bhsd.variant_launches)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == total + 1
    want = {name: n + (name == variant) for name, n in counts.items()}
    assert flash_attention_bhsd.variant_launches == want


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd", _WGMMA_BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_backward_matches_autograd_of_plain(card, b, s, h, hkv, hd, causal):
    gen = torch.Generator(device=card).manual_seed(11 * s + hd)
    q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device=card).bfloat16()
                   for n in (h, hkv, hkv, h))
    before = flash_attention_bhsd.variant_launches["backward_wgmma"]
    _, grads = _grads(flash_attention_bhsd, q, k, v, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.variant_launches["backward_wgmma"] == before + 1
    _, ref = _grads(flash_attention_bhsd_plain, q, k, v, do, causal)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=1e-5, rtol=2.0 ** -7, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_tensor_core_backward_is_deterministic(card, hd):
    """No atomics: two identical calls give identical bits, GQA 4:1."""
    gen = torch.Generator(device=card).manual_seed(hd)
    q, k, v, do = (torch.randn((n, 1000, hd), generator=gen, device=card).bfloat16()
                   for n in (16, 4, 4, 16))
    _, lse = fa_mod._forward(q, k, v, True, with_lse=True)
    first = fa_mod.flash_attention_bwd(q, k, v, lse, do, causal=True)
    second = fa_mod.flash_attention_bwd(q, k, v, lse, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


@pytest.mark.cuda
def test_flash_tensor_core_backward_rejects_an_unaligned_do(card):
    """TMA reads dO from a 16-byte-aligned base: a contiguous view one
    element into its storage is refused, not handed to the other kernel."""
    q, k, v = (torch.randn((n, 64, 128), device=card).bfloat16() for n in (4, 1, 1))
    _, lse = fa_mod._forward(q, k, v, True, with_lse=True)
    flat = torch.zeros(4 * 64 * 128 + 1, device=card, dtype=torch.bfloat16)
    dom = flat[1:].view(4, 64, 128)
    assert dom.is_contiguous() and dom.data_ptr() % 16
    before = dict(flash_attention_bhsd.variant_launches)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa_mod.flash_attention_bwd(q, k, v, lse, dom, causal=True)
    assert flash_attention_bhsd.variant_launches == before


# WKV: (b, s, h, hd) — tests/test_kernels.py::TestRwkvWkv's shapes and a
# ragged S over the model's heads
_WKV_SHAPES = [(1, 16, 1, 8), (2, 32, 2, 16), (1, 64, 4, 64), (2, 24, 2, 32),
               (1, 300, 32, 64)]
_WKV_TOL = {"f32": (2e-4, 1e-5), "bf16": (2e-4, 2.0 ** -7)}
_STATE_TOL = (1e-5, 1e-5)


def _wkv_inputs(b, s, h, hd, dtype, w_law, seed, device):
    """r/k/v/w [B,H,S,hd], u [H,hd], s0 [B,H,hd,hd] f32, from numpy.

    w is drawn per element, so a state transposed between key and value
    axes would fail: "uniform" U(0.2, 0.95), "model" the model's law
    exp(-min(exp(N(0,1)), 8)), "extreme" a tenth of zeros and the rest
    about e^-8, so that products over a chunk underflow.  ``dtype`` "bf16"
    gives bf16 r/k/v/u with f32 w (the model's mix), "bf16w" bf16 w as
    well."""
    rng = np.random.default_rng(seed)
    shape = (b, h, s, hd)
    r, k, v = (rng.normal(size=shape) for _ in range(3))
    if w_law == "uniform":
        w = rng.uniform(0.2, 0.95, size=shape)
    elif w_law == "model":
        w = np.exp(-np.minimum(np.exp(rng.normal(size=shape)), 8.0))
    else:
        w = np.where(rng.uniform(size=shape) < 0.1, 0.0,
                     np.exp(-8.0 * rng.uniform(0.9, 1.0, size=shape)))
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


def _counts():
    return wkv_bhsd.launches, dict(wkv_bhsd.variant_launches)


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
@pytest.mark.parametrize("s", [1000, 80, 33, 16, 5, 1])
@pytest.mark.parametrize("dtype", ["bf16", "bf16w"])
@pytest.mark.parametrize("w_law", ["uniform", "model", "extreme"])
def test_wkv_chunked_kernel_matches_plain(card, s, dtype, w_law):
    """The chunked kernel at ragged S and S below its 16-step chunk (those
    launched directly: the wrapper sends them to the sequential kernel),
    with w = 0 entries and decays that underflow within a chunk."""
    args = _wkv_inputs(2, s, 4, 64, dtype, w_law, s + len(w_law), card)
    ref, sT_ref = wkv_bhsd_plain(*args)
    u = args[4].float()
    out, sT = wkvk.launch("chunked", *args[:4], u, args[5])
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    _close(out, ref, _WKV_TOL["bf16"])
    _close(sT, sT_ref, _STATE_TOL)
    if s >= wkvk.CHUNKED_MIN_SEQ:
        total, counts = _counts()
        out, sT = wkv_bhsd(*args)
        assert wkv_bhsd.launches == total + 1
        assert wkv_bhsd.variant_launches["chunked"] == counts["chunked"] + 1
        _close(out, ref, _WKV_TOL["bf16"])
        _close(sT, sT_ref, _STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,s,variant", [
    ("bf16", 64, 4096, "chunked"), ("bf16w", 64, 300, "chunked"),
    ("bf16", 64, wkvk.CHUNKED_MIN_SEQ, "chunked"),
    ("bf16", 64, wkvk.CHUNKED_MIN_SEQ - 1, "sequential"), ("bf16", 64, 1, "sequential"),
    ("bf16", 32, 300, "sequential"), ("bf16", 8, 300, "sequential"),
    ("f32", 64, 300, "sequential"), ("f32", 64, 1, "sequential"),
    ("f32", 16, 300, "sequential")])
def test_wkv_kernel_variant_counts(card, dtype, hd, s, variant):
    """bf16 r/k/v at hd 64 and S >= CHUNKED_MIN_SEQ launch the chunked
    kernel, every other call the sequential one; each call raises its own
    count and the sum by one."""
    args = _wkv_inputs(1, s, 2, hd, dtype, "model", s + hd, card)
    assert wkvk.kernel_variant(args[0].dtype, args[3].dtype, hd, s) == variant
    total, counts = _counts()
    wkv_bhsd(*args)
    torch.cuda.synchronize()
    assert wkv_bhsd.launches == total + 1
    want = {name: n + (name == variant) for name, n in counts.items()}
    assert wkv_bhsd.variant_launches == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_kernel_state_passing_equals_one_call(card, dtype):
    """Two calls with the state carried across equal one call, and S=1
    steps (decode) equal it too.  Bit for bit where both sides run the
    same steps in the same order: the sequential kernel always (in bf16
    the S=1 steps and both halves of a split, launched directly, against
    one sequential launch over all 64 steps), the chunked one when the
    split falls on its 16-step chunks; within the limits where the
    chunked kernel meets the sequential one (bf16 S=1 steps) or a split
    off its chunks."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 64, 4, 64, dtype, "model", 7, card)
    out, sT = wkv_bhsd(r, k, v, w, u, s0)
    tol = _WKV_TOL[dtype]
    seq, seq_sT = wkvk.launch("sequential", r, k, v, w, u.float(), s0)

    def two_calls(split, call):
        o1, s_mid = call(r[:, :, :split], k[:, :, :split], v[:, :, :split],
                         w[:, :, :split], u, s0)
        o2, s_end = call(r[:, :, split:], k[:, :, split:], v[:, :, split:],
                         w[:, :, split:], u, s_mid)
        return torch.cat([o1, o2], dim=2), s_end

    two, s_end = two_calls(40, wkv_bhsd)
    if dtype == "f32":
        assert torch.equal(two, out) and torch.equal(s_end, sT)
    else:
        _close(two, out, tol)
        _close(s_end, sT, _STATE_TOL)
        two, s_end = two_calls(32, wkv_bhsd)
        assert torch.equal(two, out) and torch.equal(s_end, sT)
        two, s_end = two_calls(
            40, lambda *a: wkvk.launch("sequential", *a[:4], u.float(), a[5]))
        assert torch.equal(two, seq) and torch.equal(s_end, seq_sT)
    state, steps = s0, []
    for t in range(r.shape[2]):
        o, state = wkv_bhsd(*(x[:, :, t:t + 1] for x in (r, k, v, w)), u, state)
        steps.append(o)
    steps = torch.cat(steps, dim=2)
    assert torch.equal(steps, seq) and torch.equal(state, seq_sT)
    if dtype == "f32":
        assert torch.equal(steps, out) and torch.equal(state, sT)
    else:
        _close(steps, out, tol)
        _close(state, sT, _STATE_TOL)


@pytest.mark.cuda
def test_wkv_chunked_state_passing_off_the_chunk_grid(card):
    """S = 1000 split at 333 (not a multiple of 16): the second call's
    chunks start mid-way through the first call's; both calls run the
    chunked kernel, and the pair agrees with one call and with the plain
    version within the limits."""
    args = _wkv_inputs(2, 1000, 8, 64, "bf16", "model", 11, card)
    r, k, v, w, u, s0 = args
    total, counts = _counts()
    out, sT = wkv_bhsd(*args)
    o1, s_mid = wkv_bhsd(r[:, :, :333], k[:, :, :333], v[:, :, :333], w[:, :, :333], u, s0)
    o2, s_end = wkv_bhsd(r[:, :, 333:], k[:, :, 333:], v[:, :, 333:], w[:, :, 333:], u, s_mid)
    torch.cuda.synchronize()
    assert wkv_bhsd.variant_launches["chunked"] == counts["chunked"] + 3
    two = torch.cat([o1, o2], dim=2)
    _close(two, out, _WKV_TOL["bf16"])
    _close(s_end, sT, _STATE_TOL)
    ref, sT_ref = wkv_bhsd_plain(*args)
    _close(two, ref, _WKV_TOL["bf16"])
    _close(s_end, sT_ref, _STATE_TOL)


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
@pytest.mark.parametrize("dtype,s", [("bf16", 1000), ("f32", 80), ("bf16", 1)])
def test_rwkv_wkv_reads_model_layout_in_place(card, dtype, s):
    """ops.rwkv_wkv on contiguous [B,S,H,hd] tensors, as the model holds
    them: one launch, out a contiguous [B,S,H,hd] tensor, and no copy of
    r/k/v/w — the call allocates out, sT and u's f32 copy and nothing of
    r's size."""
    b, h, hd = 2, 32, 64
    r, k, v, w, u, s0 = (x.transpose(1, 2).contiguous() if x.dim() == 4 and i < 4 else x
                         for i, x in enumerate(_wkv_inputs(b, s, h, hd, dtype, "model", 5,
                                                           card)))
    assert r.shape == (b, s, h, hd) and r.is_contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total, counts = _counts()
    out, sT = rwkv_wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert wkv_bhsd.launches == total + 1
    assert out.shape == r.shape and out.is_contiguous()
    allowed = out.nbytes + sT.nbytes + 4 * u.numel() + 3 * 512   # allocator rounding
    assert grown <= allowed, (grown, allowed, r.nbytes)
    ref, sT_ref = wkv_bhsd_plain(*(x.transpose(1, 2) for x in (r, k, v, w)), u, s0)
    _close(out, ref.transpose(1, 2), _WKV_TOL[dtype])
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
    with pytest.raises(ValueError, match="contiguous"):
        wkv_bhsd(r, k, v, w, u, s0.transpose(2, 3))
    with pytest.raises(ValueError, match="one layout"):
        wkv_bhsd(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="S >= 1"):
        wkv_bhsd(*(x[:, :, :0] for x in (r, k, v, w)), u, s0)
    with pytest.raises(ValueError, match="CUDA device or all"):
        wkv_bhsd(r, k, v, w.cpu(), u, s0)
    # what the chunked kernel does not take: cp.async reads 16-byte pieces,
    # so a base or a stride off 16 bytes is refused, not handed to the
    # sequential kernel
    rb, kb, vb, wb, ub, s0b = _wkv_inputs(1, 64, 2, 64, "bf16", "model", 1, card)
    flat = torch.zeros(rb.numel() + 1, device=card, dtype=torch.bfloat16)
    rm = flat[1:].view(rb.shape)
    assert rm.is_contiguous() and rm.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        wkv_bhsd(rm, kb, vb, wb, ub, s0b)
    wide = lambda x: torch.zeros(1, 2, 64, 68, device=card, dtype=x.dtype)[..., :64]  # noqa: E731
    with pytest.raises(ValueError, match="16-byte-aligned"):
        wkv_bhsd(wide(rb), wide(kb), wide(vb), wide(wb), ub, s0b)
    assert wkv_bhsd.launches == before     # nothing launched, nothing fell back


# The WKV backward: every gradient within REL of its largest |value|, plus
# one bf16 ulp (rtol 2**-7) where it is bf16.  REL: 25x the f32 spread of
# autograd of the plain version from the f64 oracle (at most 2.5e-7 for dr,
# dk, dv, dw, ds0 and 2e-6 for du, a sum over B*S steps), as
# tests/test_torch_wkv_bwd.py measures and holds the kernel's arithmetic to.
_WKV_BWD_REL = {"du": 5e-5, "other": 6.25e-6}
_WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


def _wkv_bwd_ratio(name, got, ref):
    """Largest |got - ref| / (REL max|ref| + rtol |ref|): 1 at the limit."""
    rel = _WKV_BWD_REL["du" if name == "du" else "other"]
    rtol = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    got, ref = got.float(), ref.float()
    scale = rel * float(ref.abs().max().clamp(min=1e-30))
    return float(((got - ref).abs() / (scale + rtol * ref.abs())).max())


def _wkv_grads(fn, args, dout, dsT):
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out, sT = fn(*leaves)
    heads = [out] + ([sT] if dsT is not None else [])
    grads = torch.autograd.grad(heads, leaves, [dout] + ([dsT] if dsT is not None else []))
    return dict(zip(_WKV_GRADS, grads))


def _dropped_step(dout):
    """dout with one late step zeroed: a backward that loses one step."""
    bad = dout.clone()
    bad[:, :, 3 * dout.shape[2] // 4] = 0
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", _WKV_SHAPES + [(1, 4096, 4, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16w"])
@pytest.mark.parametrize("w_law", ["uniform", "model"])
def test_wkv_backward_matches_autograd_of_plain(card, b, s, h, hd, dtype, w_law):
    """dr, dk, dv, dw, du and ds0 through the Function (forward kernel,
    then the backward kernel backward_variant picks) against autograd of
    the plain version, with nonzero s0 and dsT; a dropped dout step is
    rejected at S >= 256; two calls give identical bits."""
    args = _wkv_inputs(b, s, h, hd, dtype, w_law, b * s + hd + 1, card)
    gen = torch.Generator(device=card).manual_seed(s)
    dout = torch.randn(args[0].shape, generator=gen, device=card).to(args[0].dtype)
    dsT = torch.randn(args[5].shape, generator=gen, device=card)
    total, counts = _counts()
    got = _wkv_grads(wkv_bhsd, args, dout, dsT)
    torch.cuda.synchronize()
    fwd = wkvk.kernel_variant(args[0].dtype, args[3].dtype, hd, s)
    bwd = wkvk.backward_variant(args[0].dtype, args[3].dtype, hd, s)
    assert wkv_bhsd.launches == total + 2
    assert wkv_bhsd.variant_launches[bwd] == counts[bwd] + 1
    assert wkv_bhsd.variant_launches[fwd] == counts[fwd] + 1
    ref = _wkv_grads(wkv_bhsd_plain, args, dout, dsT)
    for name in _WKV_GRADS:
        assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape
        assert _wkv_bwd_ratio(name, got[name], ref[name]) <= 1, name
    again = _wkv_grads(wkv_bhsd, args, dout, dsT)
    assert all(torch.equal(again[n], got[n]) for n in _WKV_GRADS)
    if s >= 256:
        bad = _wkv_grads(wkv_bhsd_plain, args, _dropped_step(dout), dsT)
        assert max(_wkv_bwd_ratio(n, bad[n], ref[n]) for n in _WKV_GRADS) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 15, 16, 17, 1000])
def test_wkv_backward_in_model_layout_without_dsT(card, s):
    """ops.rwkv_wkv's [B,S,H,hd] views with sT dropped (the model's use):
    no dsT reaches the kernel, and the gradients land in the model's
    layout.  A dout view without a unit hd stride is copied once, counted."""
    r, k, v, w, u, _ = _wkv_inputs(2, s, 4, 64, "bf16", "model", s, card)
    tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    leaves = [tr(x).requires_grad_() for x in (r, k, v, w)] + [u.requires_grad_()]
    out, _ = rwkv_wkv(*leaves)
    dout = torch.randn(out.shape[::-1], device=card).to(out.dtype).permute(3, 2, 1, 0)
    assert dout.stride(3) != 1
    copies = wkv_bhsd.dout_copies
    got = torch.autograd.grad(out, leaves, dout)
    assert wkv_bhsd.dout_copies == copies + 1
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    ref_out = wkv_bhsd_plain(*(x.transpose(1, 2) for x in plain[:4]), plain[4],
                             torch.zeros(2, 4, 64, 64, device=card))[0].transpose(1, 2)
    # at S = 1 with sT dropped, w reaches nothing: autograd gives no dw,
    # the kernel zeros
    ref = [torch.zeros_like(x) if g is None else g for x, g in zip(
        plain, torch.autograd.grad(ref_out, plain, dout, allow_unused=True))]
    for name, g, rr in zip(("dr", "dk", "dv", "dw", "du"), got, ref):
        assert g.shape == rr.shape and g.dtype == rr.dtype
        assert _wkv_bwd_ratio(name, g, rr) <= 1, name
    assert got[0].is_contiguous()        # the [B,S,H,hd] layout of r


@pytest.mark.cuda
def test_wkv_backward_returns_only_what_is_asked(card):
    """Inputs that need no grad get none; a CUDA call under no_grad
    launches the forward kernel alone."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 32, "f32", "model", 5, card)
    k.requires_grad_()
    out, _ = wkv_bhsd(r, k, v, w, u, s0)
    (dk,) = torch.autograd.grad(out.sum(), [k])
    assert dk.shape == k.shape and r.grad is None
    total = wkv_bhsd.launches
    with torch.no_grad():
        out, _ = wkv_bhsd(r, k, v, w, u, s0)
    assert out.grad_fn is None and wkv_bhsd.launches == total + 1


# The chunk-parallel backward: bf16 r/k/v at hd 64 and S >= CHUNKED_MIN_SEQ,
# at the chunk edges, a ragged S over several 4-chunk blocks, the model's
# heads, and a batch; f32 and bf16 w.
_WKV_CHUNKED_BWD_SHAPES = [(1, 16, 1, 64), (2, 17, 2, 64), (1, 63, 4, 64), (2, 64, 4, 64),
                           (1, 1000, 8, 64), (2, 300, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", _WKV_CHUNKED_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["bf16", "bf16w"])
@pytest.mark.parametrize("w_law", ["uniform", "model", "extreme"])
def test_wkv_chunked_backward_matches_autograd_of_plain(card, b, s, h, hd, dtype, w_law):
    """The chunk-parallel backward, called directly, against autograd of
    the plain version with nonzero s0 and dsT and without dsT; the planted
    fault (one late dout step dropped) is rejected at S >= 256; two calls
    give identical bits; the old backward on the same inputs meets the
    same limit."""
    args = _wkv_inputs(b, s, h, hd, dtype, w_law, 3 * s + b + len(w_law), card)
    assert wkvk.backward_variant(args[0].dtype, args[3].dtype, hd, s) == "backward_chunked"
    gen = torch.Generator(device=card).manual_seed(s + 1)
    dout = torch.randn(args[0].shape, generator=gen, device=card).to(args[0].dtype)
    dsT = torch.randn(args[5].shape, generator=gen, device=card)
    for state_grad in (dsT, None):
        ref = _wkv_grads(wkv_bhsd_plain, args, dout, state_grad)
        total, counts = _counts()
        got = dict(zip(_WKV_GRADS, wkvk.wkv_bhsd_bwd(*args, dout, state_grad)))
        torch.cuda.synchronize()
        assert wkv_bhsd.launches == total + 1
        assert wkv_bhsd.variant_launches["backward_chunked"] == counts["backward_chunked"] + 1
        for name in _WKV_GRADS:
            assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape
            assert _wkv_bwd_ratio(name, got[name], ref[name]) <= 1, (name, state_grad is None)
        again = dict(zip(_WKV_GRADS, wkvk.wkv_bhsd_bwd(*args, dout, state_grad)))
        assert all(torch.equal(again[n], got[n]) for n in _WKV_GRADS)
    old = dict(zip(_WKV_GRADS, wkvk.launch_backward("backward", *args, dout)))
    assert max(_wkv_bwd_ratio(n, old[n], ref[n]) for n in _WKV_GRADS) <= 1
    if s >= 256:
        bad = _wkv_grads(wkv_bhsd_plain, args, _dropped_step(dout), None)
        assert max(_wkv_bwd_ratio(n, bad[n], ref[n]) for n in _WKV_GRADS) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,s,variant", [
    ("bf16", 64, 4096, "backward_chunked"), ("bf16w", 64, 300, "backward_chunked"),
    ("bf16", 64, wkvk.CHUNKED_MIN_SEQ, "backward_chunked"),
    ("bf16", 64, wkvk.CHUNKED_MIN_SEQ - 1, "backward"), ("bf16", 64, 1, "backward"),
    ("bf16", 32, 300, "backward"), ("f32", 64, 300, "backward"), ("f32", 16, 40, "backward")])
def test_wkv_backward_variant_counts(card, dtype, hd, s, variant):
    """The chunk-parallel backward serves exactly the calls whose forward
    is the chunked kernel; each backward raises its own count and the sum,
    and a step of training in the model's layout copies no dout."""
    args = _wkv_inputs(1, s, 2, hd, dtype, "model", s + hd, card)
    assert wkvk.backward_variant(args[0].dtype, args[3].dtype, hd, s) == variant
    fwd = wkvk.kernel_variant(args[0].dtype, args[3].dtype, hd, s)
    leaves = [x.clone().requires_grad_() for x in args]
    out, _ = wkv_bhsd(*leaves)
    total, counts = _counts()
    copies = wkv_bhsd.dout_copies
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    assert wkv_bhsd.launches == total + 1
    assert wkv_bhsd.variant_launches == {n: c + (n == variant) for n, c in counts.items()}
    assert wkv_bhsd.dout_copies == copies
    assert (fwd == "chunked") == (variant == "backward_chunked")


@pytest.mark.cuda
def test_wkv_chunked_backward_rejects_and_copies(card):
    """What the chunk-parallel backward does not take raises before a
    launch (unaligned r/k/v/w views), and a dout view off 16-byte
    alignment is copied once, counted, with the same gradients."""
    args = _wkv_inputs(1, 64, 2, 64, "bf16", "model", 2, card)
    dout = torch.randn(args[0].shape, device=card).to(torch.bfloat16)
    total = wkv_bhsd.launches
    flat = torch.zeros(args[0].numel() + 8, device=card, dtype=torch.bfloat16)
    off = flat[1:1 + args[0].numel()].view(args[0].shape)
    assert off.data_ptr() % 16
    off.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte-aligned"):
        wkvk.wkv_bhsd_bwd(off, *args[1:], dout)
    assert wkv_bhsd.launches == total
    ref = wkvk.wkv_bhsd_bwd(*args, dout)
    flat.zero_()
    dout_off = flat[1:1 + dout.numel()].view(dout.shape)
    dout_off.copy_(dout)
    copies = wkv_bhsd.dout_copies
    got = wkvk.wkv_bhsd_bwd(*args, dout_off)
    assert wkv_bhsd.dout_copies == copies + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [300, 301, 4096])
def test_gqa_attention_with_a_window_of_at_least_s_takes_the_kernel(card, window):
    """A sliding window of at least S masks no key, so ``gqa_attention``
    on the card runs the flash kernel, and equals the chunked scan with
    that window (f32: the kernel's limit against its plain version)."""
    gen = torch.Generator(device=card).manual_seed(window)
    q = torch.randn((1, 300, 8, 128), generator=gen, device=card)
    k, v = (torch.randn((1, 300, 2, 128), generator=gen, device=card) for _ in range(2))
    before = flash_attention_bhsd.launches
    out = attention_mod.gqa_attention(q, k, v, sliding_window=window)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    og = attention_mod._chunked_gqa(q.reshape(1, 300, 2, 4, 128), k, v, causal=True,
                                    chunk=128, sliding_window=window)
    torch.testing.assert_close(out, og.reshape(q.shape), atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_gqa_attention_with_a_window_shorter_than_s_raises(card):
    q = torch.randn((1, 300, 8, 128), device=card)
    kv = torch.randn((1, 300, 2, 128), device=card)
    before = flash_attention_bhsd.launches
    with pytest.raises(NotImplementedError, match="sliding window"):
        attention_mod.gqa_attention(q, kv, kv, sliding_window=299)
    assert flash_attention_bhsd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,d,f,e,k", [(2, 16, 64, 96, 8, 2), (4, 1, 64, 96, 8, 2),
                                         (1, 512, 256, 128, 64, 8)])
def test_moe_ffn_on_the_card_matches_the_cpu_and_is_bit_equal_on_two_calls(card, g, t, d,
                                                                            f, e, k):
    """f32 (TF32 off): the card's moe_ffn against its own CPU result, at the
    CPU parity bar (1e-5; the products sum in another order), the same
    tokens in every expert slot, and two calls on the card bit-equal (the
    combine is a gather: no float atomics)."""
    gen = torch.Generator().manual_seed(g * t + e)
    p = {"router": torch.randn((d, e), generator=gen) / d ** 0.5,
         "w_gate": torch.randn((e, d, f), generator=gen) / d ** 0.5,
         "w_up": torch.randn((e, d, f), generator=gen) / d ** 0.5,
         "w_down": torch.randn((e, f, d), generator=gen) / f ** 0.5}
    x = torch.randn((g, t, d), generator=gen)
    ref_y, ref_aux = moe_ffn(p, x, top_k=k)
    pc = {name: w.to(card) for name, w in p.items()}
    first = moe_ffn(pc, x.to(card), top_k=k)
    second = moe_ffn(pc, x.to(card), top_k=k)
    torch.cuda.synchronize()
    torch.testing.assert_close(first[0].cpu(), ref_y, atol=1e-5, rtol=1e-5)
    assert abs(float(first[1]) - float(ref_aux)) <= 1e-6
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(moe_route(pc, x.to(card), top_k=k).sel_tok.cpu(),
                       moe_route(p, x, top_k=k).sel_tok)
