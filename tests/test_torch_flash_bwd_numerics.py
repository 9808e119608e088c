"""The flash backward kernel's arithmetic, rehearsed on the CPU.

``csrc/flash_attention.cu``'s backward runs only on the card.
:func:`_kernel_arithmetic` does what it does, in torch on the CPU: p
recomputed from the scores and the forward's log-sum-exp, dP = dO.V^T,
64-key tiles in the dQ pass with two f32 accumulators (sum p dP K and
sum p K) and D = rowsum(p * dP) summed in the same pass, then
dQ = scale (sum p dP K - D sum p K); dK and dV summed over the query
heads of each kv head; every gradient rounded once to the input type.

It is held against autograd of :func:`reference_attention`, the kernel's
plain version, at the card's limits: bf16 atol 1e-5 and rtol 2**-7 (one
ulp of the gradient), f32 2e-5.  FlashAttention's usual D = rowsum(dO * O)
from the saved bf16 output computes another function; the last test
records by how much it misses the bf16 limit.
"""
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
