"""The chunked WKV kernel's arithmetic, rehearsed on the CPU.

``csrc/rwkv_wkv.cu``'s chunked kernel (bf16 r/k/v, hd 64) runs only on
the card.  :func:`_kernel_arithmetic` does what it does, step by step, in
torch on the CPU: chunks of 16 steps; inside a chunk the decays
``P_t = prod_{s<t} w_s`` and ``E_b = prod_{b<s<16} w_s`` as running
products of w (no log, no division, no clamp), steps past S taken with
w = 1; the diagonal block ``A[t][b] = sum_i r_t k_b prod_{b<s<t} w_s`` by
direct running products and the bonus ``sum_i r_t u k_t`` on its
diagonal; every f32 operand of a tensor-core product split into bf16
parts, the partial products summed in f32 (a product of two bf16 values
is exact in f32, as on the tensor cores); the state updated once per
chunk; one rounding of out to bf16.

It is held against :func:`reference_wkv`, the kernel's plain version, at
the card's limits (``chip_smoke.py``'s ``WKV_TOL["bf16"]`` and
``WKV_STATE_TOL``).  The last tests record why the operands are split:
one bf16 rounding of r*P, k*E, A and S misses both limits by orders of
magnitude, and two parts of k*E leave the state no margin.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import reference_wkv

_OUT_TOL = (2e-4, 2.0 ** -7)      # chip_smoke.py WKV_TOL["bf16"]: (atol, rtol)
_STATE_TOL = (1e-5, 1e-5)         # chip_smoke.py WKV_STATE_TOL
_C = 16                           # steps per chunk of the kernel
# bf16 parts of (r*P and S in the cross product, k*E in the update, A)
_KERNEL_PARTS = (2, 3, 2)


def _split(x, n):
    """x as n bf16 parts (held in f32): bf16(x), bf16 of what is left, ..."""
    parts, rest = [], x
    for _ in range(n):
        part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


def _products(a_parts, b_parts):
    """Sum of a_i @ b_j over the parts whose orders reach f32: i + j below
    the larger part count (hi.hi, hi.lo and lo.hi of two halves)."""
    n = max(len(a_parts), len(b_parts))
    return sum(a @ b for i, a in enumerate(a_parts) for j, b in enumerate(b_parts)
               if i + j < n)


def _kernel_arithmetic(r, k, v, w, u, s0, parts=_KERNEL_PARTS):
    """The chunked kernel's function on r/k/v bf16 [B,H,S,hd], w f32 or
    bf16, u [H,hd], s0 [B,H,hd,hd] f32; returns (out bf16, sT f32)."""
    n_cross, n_update, n_a = parts
    b, h, s, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None]                                   # [1, H, hd]
    state = s0.float().clone()                             # S[key i][value j]
    out = torch.empty((b, h, s, hd))
    for t0 in range(0, s, _C):
        n = min(_C, s - t0)
        pad = (0, 0, 0, _C - n)
        rc, kc, vc = (F.pad(x[:, :, t0:t0 + n], pad) for x in (rf, kf, vf))
        wc = F.pad(wf[:, :, t0:t0 + n], pad, value=1.0)    # w past S is 1
        rp, ke = torch.empty_like(rc), torch.empty_like(kc)
        run = torch.ones_like(wc[:, :, 0])
        for t in range(_C):                                # r_t * prod_{s<t} w_s
            rp[:, :, t] = rc[:, :, t] * run
            run = run * wc[:, :, t]
        p16 = run
        run = torch.ones_like(wc[:, :, 0])
        for t in range(_C - 1, -1, -1):                    # k_b * prod_{b<s<C} w_s
            ke[:, :, t] = kc[:, :, t] * run
            run = run * wc[:, :, t]
        a = torch.zeros((b, h, _C, _C))
        for bb in range(_C):
            x = kc[:, :, bb]
            a[:, :, bb, bb] = (rc[:, :, bb] * uf * x).sum(-1)
            for t in range(bb + 1, _C):
                a[:, :, t, bb] = (rc[:, :, t] * x).sum(-1)
                x = x * wc[:, :, t]
        cross = _products(_split(rp, n_cross), _split(state, n_cross))
        intra = _products(_split(a, n_a), [vc])
        out[:, :, t0:t0 + n] = (cross + intra)[:, :, :n]
        state = state * p16[..., None] + _products(_split(ke.transpose(-1, -2), n_update),
                                                   [vc])
    return out.bfloat16(), state


def _inputs(b, s, h, w_law, seed, *, hd=64, s0=True, bf16_w=False):
    """bf16 r/k/v/u, f32 (or bf16) w and f32 s0, [B,H,S,hd], from numpy.

    w by the JAX kernel tests' law ("uniform": U(0.2, 0.95)), the model's
    ("model": exp(-min(exp(N(0,1)), 8))), "zeros" (a quarter of the
    entries 0, the rest uniform) or "underflow" (about e^-8 everywhere, so
    a chunk's products underflow f32)."""
    rng = np.random.default_rng(seed)
    shape = (b, h, s, hd)
    r, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float32).bfloat16()
               for _ in range(3))
    if w_law == "uniform":
        w = rng.uniform(0.2, 0.95, size=shape)
    elif w_law == "model":
        w = np.exp(-np.minimum(np.exp(rng.normal(size=shape)), 8.0))
    elif w_law == "zeros":
        w = np.where(rng.uniform(size=shape) < 0.25, 0.0, rng.uniform(0.2, 0.95, size=shape))
    else:
        w = np.exp(-8.0 * rng.uniform(0.95, 1.0, size=shape))
    w = torch.tensor(w, dtype=torch.float32)
    if bf16_w:
        w = w.bfloat16()
    u = torch.tensor(rng.normal(size=(h, hd)), dtype=torch.float32).bfloat16()
    s0 = (torch.tensor(rng.normal(size=(b, h, hd, hd)), dtype=torch.float32) if s0
          else torch.zeros((b, h, hd, hd)))
    return r, k, v, w, u, s0


def _ratio(out, ref, tol):
    """Largest |out - ref| / (atol + rtol |ref|): at most 1 within the limit."""
    atol, rtol = tol
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


def _assert_within(args, parts=_KERNEL_PARTS):
    out, sT = _kernel_arithmetic(*args, parts=parts)
    ref, sT_ref = reference_wkv(*args)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=_OUT_TOL[0], rtol=_OUT_TOL[1])
    torch.testing.assert_close(sT, sT_ref, atol=_STATE_TOL[0], rtol=_STATE_TOL[1])


@pytest.mark.parametrize("w_law", ["uniform", "model", "zeros", "underflow"])
@pytest.mark.parametrize("s", [96, 53])
def test_chunked_arithmetic_meets_the_limits(w_law, s):
    """Every law of w, at a whole number of chunks and a ragged S, from a
    nonzero s0."""
    _assert_within(_inputs(1, s, 2, w_law, seed=s + len(w_law)))


@pytest.mark.parametrize("s", [1, 5, 15])
@pytest.mark.parametrize("with_s0", [True, False])
def test_chunked_arithmetic_below_one_chunk(s, with_s0):
    """S shorter than one chunk: the padded steps must not decay the state."""
    _assert_within(_inputs(2, s, 2, "model", seed=s, s0=with_s0))


def test_chunked_arithmetic_with_bf16_w():
    """w read as bf16 (the kernel takes either type of w)."""
    _assert_within(_inputs(1, 40, 2, "model", seed=3, bf16_w=True))


def test_underflowing_decays_clear_the_state():
    """With w about e^-8 a chunk's decay underflows to 0 in f32: the old
    state is gone after one chunk on both sides, with no NaN or inf from a
    division or a log."""
    args = _inputs(1, 32, 2, "underflow", seed=9)
    out, sT = _kernel_arithmetic(*args)
    assert bool(torch.isfinite(out.float()).all() and torch.isfinite(sT).all())
    assert float(torch.prod(args[3][..., :16, :], dim=2).max()) == 0.0
    _assert_within(args)


@pytest.mark.parametrize("w_law", ["uniform", "model"])
def test_one_bf16_rounding_misses_the_limits(w_law):
    """Why the kernel splits its f32 operands: one bf16 rounding of r*P,
    k*E, A and S misses the out limit and the state limit by more than
    10x, while the kernel's parts stay within both.  Two parts of k*E
    (three in the kernel) take more than 10x the kernel's share of the
    state limit: 0.40 of it here, and 1.49 on the uniform law at four
    heads, so they would cross it on some inputs."""
    args = _inputs(1, 300, 2, w_law, seed=1)
    ref, sT_ref = reference_wkv(*args)
    ratios = {}
    for name, parts in (("kernel", _KERNEL_PARTS), ("once", (1, 1, 1)),
                        ("two_part_update", (2, 2, 2))):
        out, sT = _kernel_arithmetic(*args, parts=parts)
        ratios[name] = (_ratio(out, ref, _OUT_TOL), _ratio(sT, sT_ref, _STATE_TOL))
    assert max(ratios["kernel"]) <= 1.0, ratios
    assert min(ratios["once"]) > 10.0, ratios
    assert ratios["two_part_update"][1] > 10.0 * ratios["kernel"][1], ratios
