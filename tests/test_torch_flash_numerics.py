"""The tensor-core flash kernel's arithmetic, rehearsed on the CPU.

``csrc/flash_attention.cu``'s bf16 kernel (hd 64 and 128) runs only on
the card.  :func:`_kernel_arithmetic` does what it does, step by step, in
torch on the CPU: exact f32 products of bf16 q and k, the scale applied
to the scores (in log2 units, so that exp2 gives exp), the tail and
causal masks with -1e30, an online softmax over 128-key tiles with f32
running max and sum, p split into bf16 ``hi = bf16(p)`` and
``lo = bf16(p - hi)``, the two P.V products in f32, and one rounding of
the output to bf16.

It is held against :func:`reference_attention`, the kernel's plain
version, at the card's bf16 limit: atol 1e-5 and rtol 2**-7, one bf16
ulp of the output, because both compute in f32 and round once.  Rounding
p once to bf16 instead, as tensor-core attention usually does, computes
another function; the last test records by how much it misses that limit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import reference_attention

_ATOL, _RTOL = 1e-5, 2.0 ** -7      # the bf16 limit of chip_smoke.py
_BLOCK_K = 128                      # keys per K/V tile of the kernel
_NEG_INF = -1e30


def _kernel_arithmetic(q, k, v, *, causal, split=True):
    """The tensor-core kernel's function on bf16 q [BHq,S,hd], k/v [BHkv,S,hd]."""
    bh, s, hd = q.shape
    group = bh // k.shape[0]
    # GQA: query head b reads kv head b // group
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    qf = q.float()
    scale = torch.tensor(hd ** -0.5 * math.log2(math.e), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), _NEG_INF)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, hd))
    for k0 in range(0, s, _BLOCK_K):
        kt, vt = kf[:, k0:k0 + _BLOCK_K], vf[:, k0:k0 + _BLOCK_K]
        scores = (qf @ kt.transpose(1, 2)) * scale      # unscaled products, then the scale
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            scores = scores.masked_fill(cols > rows, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp2(scores - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)      # from the f32 p
        hi = p.bfloat16().float()
        if split:
            lo = (p - hi).bfloat16().float()
            pv = hi @ vt + lo @ vt
        else:
            pv = hi @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _inputs(s, hd, seed, h=4, hkv=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(n, s, hd)).astype(np.float32)).bfloat16()
                 for n in (h, hkv, hkv))


def _limit_ratio(out, ref):
    """Largest |out - ref| / (atol + rtol |ref|): at most 1 within the limit."""
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (_ATOL + _RTOL * ref.abs())).max())


@pytest.mark.parametrize("s", [129, 1024])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_meets_the_bf16_limit(s, hd, causal):
    q, k, v = _inputs(s, hd, seed=s + hd + causal)
    out = _kernel_arithmetic(q, k, v, causal=causal)
    ref = reference_attention(q, k, v, causal=causal)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=_ATOL, rtol=_RTOL)


@pytest.mark.parametrize("s", [129, 1024])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_p_rounded_once_misses_the_limit(s, hd, causal):
    """Why the kernel splits p: one bf16 rounding of p before P.V misses
    the limit by more than 10x, while the split stays within it."""
    q, k, v = _inputs(s, hd, seed=s + hd + causal)
    ref = reference_attention(q, k, v, causal=causal)
    once = _limit_ratio(_kernel_arithmetic(q, k, v, causal=causal, split=False), ref)
    split = _limit_ratio(_kernel_arithmetic(q, k, v, causal=causal), ref)
    assert split <= 1.0 and once > 10.0, (split, once)
