"""The flash backward kernels' arithmetic, rehearsed on the CPU.

``csrc/flash_attention.cu``'s backward kernels run only on the card.
:func:`_kernel_arithmetic` does what the CUDA-core one does, in torch on
the CPU: p recomputed from the scores and the forward's log-sum-exp,
dP = dO.V^T, 64-key tiles in the dQ pass with two f32 accumulators
(sum p dP K and sum p K) and D = rowsum(p * dP) summed in the same pass,
then dQ = scale (sum p dP K - D sum p K); dK and dV summed over the query
heads of each kv head; every gradient rounded once to the input type.

:func:`_tensor_core_arithmetic` does what the tensor-core one (bf16 at
hd 64 and 128) does: exact f32 products of bf16 operands; p in log2
units, exp2(S scale log2(e) - lse log2(e)); its dQ kernel's two sweeps
over 64-key tiles, the first summing D = rowsum(p * dP) in f32, the
second adding dS.K with dS = p (dP - D) split into bf16 ``hi = bf16(dS)``
and ``lo = bf16(dS - hi)``; its dK/dV kernel walking 64-row q steps of
every query head of the group, with P^T and dS^T split the same way
before P^T.dO and dS^T.q.  Its sums are f32 with round-to-nearest adds,
which the kernel keeps by moving its tensor-core sums into f32 masters
every four tiles.

Both are held against autograd of :func:`reference_attention`, the
kernels' plain version, at the card's limits: bf16 atol 1e-5 and rtol
2**-7 (one ulp of the gradient), f32 2e-5.  FlashAttention's usual
D = rowsum(dO * O) from the saved bf16 output computes another function,
and so does one bf16 rounding of P^T or dS before the tensor cores; the
tests record by how much each misses the bf16 limit.
"""
import math

import pytest
import torch

from repro_torch.kernels import reference_attention

_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
_TILE = 64


def _kernel_arithmetic(q, k, v, do, *, causal, d_from_o=None):
    """(dq, dk, dv) of the backward kernel on q [BHq,S,hd], k/v [BHkv,S,hd]."""
    bh, s, hd = q.shape
    group = bh // k.shape[0]
    scale = hd ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    scores = (qf @ kf.transpose(1, 2)) * scale
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    lse = torch.logsumexp(scores.masked_fill(~keep, float("-inf")), dim=-1, keepdim=True)
    acc_a = torch.zeros(bh, s, hd)
    acc_b = torch.zeros(bh, s, hd)
    dsum = torch.zeros(bh, s, 1)
    for k0 in range(0, s, _TILE):        # the dQ pass, one key tile at a time
        cols = slice(k0, k0 + _TILE)
        p = torch.where(keep[:, cols], torch.exp(scores[:, :, cols] - lse), 0.0)
        pdp = p * (dof @ vf[:, cols].transpose(1, 2))
        dsum += pdp.sum(dim=-1, keepdim=True)
        acc_a += pdp @ kf[:, cols]
        acc_b += p @ kf[:, cols]
    delta = dsum if d_from_o is None else (dof * d_from_o.float()).sum(-1, keepdim=True)
    if d_from_o is None:
        dq = scale * (acc_a - delta * acc_b)
    else:                                # FlashAttention's form: dS from the given D
        p = torch.where(keep, torch.exp(scores - lse), 0.0)
        dq = scale * ((p * (dof @ vf.transpose(1, 2) - delta)) @ kf)
    p = torch.where(keep, torch.exp(scores - lse), 0.0)
    ds = p * (dof @ vf.transpose(1, 2) - delta)
    fold = lambda t: t.reshape(k.shape[0], group, s, hd).sum(dim=1)  # noqa: E731
    dk = fold(scale * (ds.transpose(1, 2) @ qf))
    dv = fold(p.transpose(1, 2) @ dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _inputs(s, hd, dtype, seed, h=4, hkv=2):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((n, s, hd), generator=gen).to(dtype) for n in (h, hkv, hkv, h)]


def _reference(q, k, v, do, causal):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = reference_attention(*leaves, causal=causal)
    return out.detach(), torch.autograd.grad(out, leaves, do)


def _ratio(out, ref, dtype):
    atol, rtol = _TOL[dtype]
    return float(((out.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max())


@pytest.mark.parametrize("s,hd", [(1, 64), (64, 32), (300, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_meets_the_limits(s, hd, dtype, causal):
    q, k, v, do = _inputs(s, hd, dtype, seed=s + hd)
    _, ref = _reference(q, k, v, do, causal)
    for name, g, r in zip(("dq", "dk", "dv"), _kernel_arithmetic(q, k, v, do, causal=causal),
                          ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _ratio(g, r, dtype) <= 1.0, name


@pytest.mark.parametrize("s", [64, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_d_from_the_rounded_output_misses_the_limit(s, causal):
    """D = rowsum(dO * O) with O rounded to bf16 puts an error of up to
    2**-9 |dO||O| into every dS of the row: dQ and dK miss the one-ulp
    limit several times over (6-160x at S = 64-1000, hd 32-128)."""
    q, k, v, do = _inputs(s, 64, torch.bfloat16, seed=s)
    out, ref = _reference(q, k, v, do, causal)
    dq, dk, _ = _kernel_arithmetic(q, k, v, do, causal=causal, d_from_o=out)
    assert max(_ratio(dq, ref[0], torch.bfloat16), _ratio(dk, ref[1], torch.bfloat16)) > 3.0


_BLOCK_K = 64       # keys per K/V tile of the dQ kernel
_STEP_Q = 64        # q rows per step of the dK/dV kernel
_LOG2E = math.log2(math.e)


def _split(x, split=True):
    """x as the bf16 parts the kernel hands the tensor cores, in f32."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _tensor_core_arithmetic(q, k, v, do, *, causal, split_p=True, split_ds=True):
    """(dq, dk, dv) of the tensor-core backward on bf16 q [BHq,S,hd],
    k/v [BHkv,S,hd]; ``split_p`` / ``split_ds`` False round P^T / dS
    once to bf16 instead of splitting them."""
    bh, s, hd = q.shape
    bh_kv = k.shape[0]
    group = bh // bh_kv
    scale = torch.tensor(hd ** -0.5)
    scale_log2 = scale * torch.tensor(_LOG2E)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(group, dim=0), vf.repeat_interleave(group, dim=0)
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    # the forward's natural-log lse, taken to log2 units
    lse = torch.logsumexp((qf @ kr.transpose(1, 2) * scale).masked_fill(~keep, float("-inf")),
                          dim=-1)
    lse2 = lse * torch.tensor(_LOG2E)

    def p_dp(k0):                        # one 64-key tile of the dQ kernel
        cols = slice(k0, k0 + _BLOCK_K)
        p = torch.where(keep[:, cols],
                        torch.exp2(qf @ kr[:, cols].transpose(1, 2) * scale_log2 - lse2[..., None]),
                        0.0)
        return p, dof @ vr[:, cols].transpose(1, 2)

    d = torch.zeros(bh, s, 1)            # sweep 1: D
    for k0 in range(0, s, _BLOCK_K):
        p, dp = p_dp(k0)
        d += (p * dp).sum(dim=-1, keepdim=True)
    acc = torch.zeros(bh, s, hd)         # sweep 2: dS.K
    for k0 in range(0, s, _BLOCK_K):
        p, dp = p_dp(k0)
        for part in _split(p * (dp - d), split_ds):
            acc += part @ kr[:, k0:k0 + _BLOCK_K]

    # the dK/dV kernel: keys on the rows, every head of the group in turn
    qg, dog = qf.reshape(bh_kv, group, s, hd), dof.reshape(bh_kv, group, s, hd)
    lse2g, dg = lse2.reshape(bh_kv, group, s), d.reshape(bh_kv, group, s)
    acc_dk, acc_dv = torch.zeros(bh_kv, s, hd), torch.zeros(bh_kv, s, hd)
    for h in range(group):
        for q0 in range(0, s, _STEP_Q):
            rows = slice(q0, q0 + _STEP_Q)
            qt, dot = qg[:, h, rows], dog[:, h, rows]
            pt = torch.where(keep[rows].T,
                             torch.exp2(kf @ qt.transpose(1, 2) * scale_log2
                                        - lse2g[:, h, None, rows]), 0.0)
            dst = pt * (vf @ dot.transpose(1, 2) - dg[:, h, None, rows])
            for part in _split(pt, split_p):
                acc_dv += part @ dot
            for part in _split(dst, split_ds):
                acc_dk += part @ qt
    return (scale * acc).bfloat16(), (scale * acc_dk).bfloat16(), acc_dv.bfloat16()


@pytest.mark.parametrize("s", [1, 64, 300, 1000])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_tensor_core_backward_meets_the_bf16_limit(s, hd, causal, group):
    q, k, v, do = _inputs(s, hd, torch.bfloat16, seed=s + hd, h=4, hkv=4 // group)
    _, ref = _reference(q, k, v, do, causal)
    for name, g, r in zip(("dq", "dk", "dv"),
                          _tensor_core_arithmetic(q, k, v, do, causal=causal), ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _ratio(g, r, torch.bfloat16) <= 1.0, name


@pytest.mark.parametrize("s", [300, 1000])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_one_rounding_of_p_or_ds_misses_the_limit(s, hd, causal):
    """Why the kernel splits P^T and dS: one bf16 rounding of P^T before
    P^T.dO misses the limit in dV, and one of dS in dQ and dK, by more than
    10x at each of these shapes, while the split stays within it."""
    q, k, v, do = _inputs(s, hd, torch.bfloat16, seed=s + hd, h=4, hkv=4)
    _, (dq, dk, dv) = _reference(q, k, v, do, causal)
    bf = torch.bfloat16
    split = _tensor_core_arithmetic(q, k, v, do, causal=causal)
    once_p = _tensor_core_arithmetic(q, k, v, do, causal=causal, split_p=False)
    once_ds = _tensor_core_arithmetic(q, k, v, do, causal=causal, split_ds=False)
    assert max(_ratio(g, r, bf) for g, r in zip(split, (dq, dk, dv))) <= 1.0
    assert _ratio(once_p[2], dv, bf) > 10.0
    assert min(_ratio(once_ds[0], dq, bf), _ratio(once_ds[1], dk, bf)) > 10.0
