"""The chunk-parallel WKV backward's arithmetic, on the CPU.

``csrc/rwkv_wkv.cu``'s ``"backward_chunked"`` kernel (bf16 r/k/v at hd 64)
runs only on the card.  It computes the gradient in three phases: the
state chain and the gradient chain over 16-step chunks (on the tensor
cores, a*F split into bf16 parts), then every chunk on its own in f32.
Held here, with inputs from numpy seeds:

* ``wkv_bhsd_bwd_chunked_plain`` (the three phases in torch f32) against
  autograd of an f64 oracle within a quarter of the card's limit (half
  for bf16 gradients, which take half an ulp by their own rounding): ragged
  S, S below one chunk, nonzero s0 and dsT, no dsT, and every w near e^-8
  at S = 4096; and against ``jax.grad`` of the JAX model's
  ``wkv_scan_ref`` and ``wkv_chunked``, at tests/test_torch_wkv_bwd.py's
  tolerances.
* The chains' bf16-split arithmetic (``_chains``): k*E or r*P in
  three bf16 parts against exact bf16 v or dout, products exact and summed
  in f32, as on the tensor cores, against the same chains in f64, within
  the forward's state limit (``chip_smoke.py``'s ``WKV_STATE_TOL``); one
  bf16 rounding misses it by more than 10x.
* ``backward_variant``: the chunk-parallel kernel exactly where the chunked
  forward runs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import rwkv as jrwkv

wkvk = importlib.import_module("repro_torch.kernels.rwkv_wkv")

GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
# tests/test_torch_wkv_bwd.py: the card's limit (25x the f32 spread from the
# f64 oracle) and the tolerances against jax.grad
BWD_REL = {"du": 5e-5, "other": 6.25e-6}
_JAX_SCAN_TOL = {"f32": 1e-5, "bf16": 2e-2}
_JAX_CHUNKED_TOL = 1e-3
_STATE_TOL = (1e-5, 1e-5)         # chip_smoke.py WKV_STATE_TOL: (atol, rtol)
_C = wkvk.BWD_CHUNK


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of tiny torch operations: other threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, s, h, hd, seed, w_law="model", layout="bhsd", dtype=np.float64):
    """r, k, v, w, u, s0, dout, dsT as numpy (tests/test_torch_wkv_bwd.py's
    laws of w: "model", "uniform" U(0.2, 0.95), "tiny" exp(-U(7.5, 8)))."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd) if layout == "bshd" else (b, h, s, hd)
    r, k, v, dout = (rng.normal(size=shape) for _ in range(4))
    if w_law == "model":
        w = np.exp(-np.minimum(np.exp(rng.normal(size=shape)), 7.9))
    elif w_law == "uniform":
        w = rng.uniform(0.2, 0.95, size=shape)
    else:
        w = np.exp(-rng.uniform(7.5, 8.0, size=shape))
    u = rng.normal(size=(h, hd))
    s0, dsT = (rng.normal(size=(b, h, hd, hd)) for _ in range(2))
    return tuple(x.astype(dtype) for x in (r, k, v, w, u, s0, dout, dsT))


def _oracle_f64(r, k, v, w, u, s0):
    state, outs = s0, []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], state + u[None, :, :, None] * kv))
        state = state * w[:, :, t, :, None] + kv
    return torch.stack(outs, dim=2), state


def _oracle_grads(r, k, v, w, u, s0, dout, dsT):
    leaves = [x.double().detach().clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    out, sT = _oracle_f64(*leaves)
    loss = (out * dout.double()).sum() + (0.0 if dsT is None else (sT * dsT.double()).sum())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # at S = 1 with dsT absent w reaches nothing: autograd gives no dw
    return {n: torch.zeros_like(x) if g is None else g for n, x, g in zip(GRADS, leaves, grads)}


def _limit_ratio(name, got, ref) -> float:
    """|got - ref| / (BWD_REL max|ref| + rtol |ref|), rtol one bf16 ulp for
    a bf16 gradient: at most 1 within the card's limit."""
    rel = BWD_REL["du" if name == "du" else "other"]
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, ref = got.double(), ref.double()
    scale = rel * ref.abs().max().clamp(min=1e-300)
    return float(((got - ref).abs() / (scale + rtol * ref.abs())).max())


def _rel(got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


# ----------------------------------------------------------------------
# the three phases in f32 against the f64 oracle
# ----------------------------------------------------------------------
_ORACLE_CASES = [(1, 16, 1, 64, "uniform"), (2, 37, 2, 64, "model"), (1, 5, 2, 64, "model"),
                 (2, 33, 2, 32, "tiny"), (1, 1024, 2, 64, "model"),
                 (1, 4096, 1, 64, "tiny")]


@pytest.mark.parametrize("b,s,h,hd,w_law", _ORACLE_CASES)
def test_chunked_plain_backward_matches_f64_autograd(b, s, h, hd, w_law):
    """Nonzero s0 and dsT; below S = 1024 also bf16 r/k/v/dout (f32 w),
    held against the oracle at the rounded inputs."""
    args = [torch.from_numpy(x) for x in _inputs(b, s, h, hd, seed=3 * s + hd, w_law=w_law)]
    dtypes = (torch.float32,) if s >= 1024 else (torch.float32, torch.bfloat16)
    for dtype in dtypes:
        r, k, v, w, u, s0, dout, dsT = (x.float() for x in args)
        r, k, v, dout = (x.to(dtype) for x in (r, k, v, dout))
        ref = _oracle_grads(r, k, v, w, u, s0, dout, dsT)
        got = dict(zip(GRADS, wkvk.wkv_bhsd_bwd_chunked_plain(r, k, v, w, u, s0, dout, dsT)))
        for name in GRADS:
            assert got[name].dtype == (dtype if name in ("dr", "dk", "dv") else torch.float32)
            assert got[name].shape == ref[name].shape
            quota = 0.5 if got[name].dtype == torch.bfloat16 else 0.25
            assert _limit_ratio(name, got[name], ref[name]) <= quota, (dtype, name)


@pytest.mark.parametrize("s", [1, 15, 16, 17, 50])
def test_chunked_plain_backward_without_dsT_at_chunk_edges(s):
    """S around the 16-step chunk, dsT absent (the model drops sT), bf16 w:
    the padded steps (w = 1, the rest 0) change nothing."""
    r, k, v, w, u, s0, dout, _ = (torch.from_numpy(x).float()
                                  for x in _inputs(2, s, 2, 64, seed=s, w_law="uniform"))
    w = w.bfloat16()
    ref = _oracle_grads(r, k, v, w, u, s0, dout, None)
    got = wkvk.wkv_bhsd_bwd_chunked_plain(r, k, v, w, u, s0, dout)
    assert got[3].dtype == torch.bfloat16
    for name, g in zip(GRADS, got):
        quota = 0.5 if g.dtype == torch.bfloat16 else 0.25
        assert _limit_ratio(name, g, ref[name]) <= quota, name


def test_chunked_plain_equals_the_sequential_plain_backward():
    """The two backwards' plain versions compute one function: within f32
    noise of each other at a ragged S with a nonzero s0 and dsT."""
    args = [torch.from_numpy(x).float() for x in _inputs(2, 70, 2, 64, seed=8)]
    one = wkvk.wkv_bhsd_bwd_chunked_plain(*args)
    two = wkvk.wkv_bhsd_bwd_plain(*args)
    for name, a, b in zip(GRADS, one, two):
        assert _rel(a, b) <= 1e-6, name


# ----------------------------------------------------------------------
# against jax.grad of the JAX model's WKV
# ----------------------------------------------------------------------
def _jax_grads(fn, args, with_state, dtype):
    """jax.grad of sum(out * dout) [+ sum(sT * dsT)] for the JAX model's
    ``fn`` on model-layout numpy inputs, w.r.t. r, k, v, w, u, s0."""
    r, k, v, w, u, s0, dout, dsT = args
    cast = lambda x: jnp.asarray(x, dtype)  # noqa: E731

    def loss(r, k, v, w, u, s0):
        out, sT = fn(r, k, v, w, u, s0)
        val = jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout, jnp.float32))
        return val + (jnp.sum(sT * jnp.asarray(dsT, jnp.float32)) if with_state else 0.0)
    grads = jax.grad(loss, argnums=tuple(range(6)))(
        cast(r), cast(k), cast(v), jnp.asarray(w, jnp.float32), cast(u),
        jnp.asarray(s0 if with_state else np.zeros_like(s0), jnp.float32))
    return dict(zip(GRADS, (np.asarray(g, np.float32) for g in grads)))


# (b, s, h, with s0 and dsT, dtype, JAX function), hd 64: the kernel's head
# dim; ragged S, S below a chunk
_JAX_CASES = [(2, 37, 2, True, "f32", "wkv_scan_ref"), (1, 64, 2, False, "bf16", "wkv_scan_ref"),
              (2, 5, 2, True, "bf16", "wkv_scan_ref"), (1, 64, 2, True, "f32", "wkv_chunked"),
              (2, 37, 2, False, "bf16", "wkv_chunked")]


@pytest.mark.parametrize("b,s,h,with_state,dtype,jax_fn", _JAX_CASES)
def test_chunked_plain_backward_matches_jax_grad(b, s, h, with_state, dtype, jax_fn):
    """The plain chunk-parallel gradient on [B,H,S,hd] views of model-
    layout tensors against jax.grad; bf16 is bf16 r/k/v/u/dout with f32 w,
    the model's mix."""
    args = _inputs(b, s, h, 64, seed=s + 7 * with_state, layout="bshd", dtype=np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    r, k, v, w, u, s0, dout, dsT = (torch.from_numpy(x) for x in args)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    got = wkvk.wkv_bhsd_bwd_chunked_plain(
        tr(r.to(tdt)), tr(k.to(tdt)), tr(v.to(tdt)), tr(w), u.to(tdt),
        s0 if with_state else torch.zeros_like(s0), tr(dout.to(tdt)).float(),
        dsT if with_state else None)
    ref = _jax_grads(getattr(jrwkv, jax_fn), args, with_state, jdt)
    for name, g in zip(GRADS, got):
        if name == "ds0" and not with_state:
            continue
        g = tr(g) if name in ("dr", "dk", "dv", "dw") else g
        tol = _JAX_SCAN_TOL[dtype] if jax_fn == "wkv_scan_ref" else _JAX_CHUNKED_TOL
        if dtype == "bf16" and name in ("dr", "dk", "dv", "du"):
            tol = max(tol, _JAX_SCAN_TOL["bf16"])
        assert _rel(g.float(), torch.from_numpy(ref[name].copy())) <= tol, name


# ----------------------------------------------------------------------
# the chains' bf16-split arithmetic
# ----------------------------------------------------------------------
def _split(x, n):
    """x as n bf16 parts (held in f32): bf16(x), bf16 of what is left, ..."""
    parts, rest = [], x
    for _ in range(n):
        part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


def _chains(r, k, v, w, s0, dout, dsT, parts=None):
    """The two chains of the kernel: the checkpoints S_c (state before chunk
    c) and Ghat_c (gradient after chunk c), and ds0.  parts=None runs them
    in f64 from f64 decays; an int n runs them as the kernel does: decays
    and a*F in f32, a*F in n bf16 parts, each part times exact bf16 v or
    dout (exact in f32), summed in f32."""
    b, h, s, hd = r.shape
    n = -(-s // _C)
    pad = (0, 0, 0, n * _C - s)
    dt = torch.float64 if parts is None else torch.float32
    chunks = lambda t, value=0.0: F.pad(t.to(dt), pad, value=value).view(b, h, n, _C, hd)  # noqa: E731
    rc, kc, vc, dc = (chunks(t) for t in (r, k, v, dout))
    p_excl, e_excl, p_end = wkvk._chunk_decays(chunks(w, 1.0))
    ke, rp = kc * e_excl, rc * p_excl

    def update(x, af, bm, decay):
        pieces = [af] if parts is None else _split(af, parts)[::-1]   # least first
        x = decay[..., None] * x
        for piece in pieces:
            x = x + piece.transpose(-1, -2) @ bm
        return x
    x, states = s0.to(dt), []
    for i in range(n):
        states.append(x)
        x = update(x, ke[:, :, i], vc[:, :, i], p_end[:, :, i])
    x, grads = dsT.to(dt), [None] * n
    for i in reversed(range(n)):
        grads[i] = x
        x = update(x, rp[:, :, i], dc[:, :, i], p_end[:, :, i])
    return torch.stack(states, 2), torch.stack(grads, 2), x


def _chain_inputs(s, w_law, seed):
    """bf16 r/k/v/dout, f32 w, f32 s0 and dsT, [1,2,S,64]."""
    r, k, v, w, _, s0, dout, dsT = (torch.from_numpy(x).float()
                                    for x in _inputs(1, s, 2, 64, seed=seed, w_law=w_law))
    return (r.bfloat16(), k.bfloat16(), v.bfloat16(), w, s0, dout.bfloat16(), dsT)


def _state_ratio(got, ref) -> float:
    atol, rtol = _STATE_TOL
    return float(((got.double() - ref).abs() / (atol + rtol * ref.abs())).max())


@pytest.mark.parametrize("w_law", ["uniform", "model", "tiny"])
@pytest.mark.parametrize("s", [300, 53])
def test_chain_split_arithmetic_meets_the_state_limit(w_law, s):
    """Both chains with a*F in three bf16 parts: every checkpoint and ds0
    within the state limit of the f64 chains."""
    args = _chain_inputs(s, w_law, seed=s + len(w_law))
    ref = _chains(*args)
    got = _chains(*args, parts=3)
    for name, g, rf in zip(("states", "grads", "ds0"), got, ref):
        assert _state_ratio(g, rf) <= 1.0, name


def test_one_bf16_rounding_misses_the_state_limit():
    """Why the chains split a*F: rounded once to bf16, r*P and k*E take the
    checkpoints more than 10x past the state limit; in three parts they
    stay within it."""
    args = _chain_inputs(300, "model", seed=1)
    ref = _chains(*args)
    ratios = {n: max(_state_ratio(g, rf) for g, rf in zip(_chains(*args, parts=n), ref))
              for n in (1, 3)}
    assert ratios[3] <= 1.0 and ratios[1] > 10.0, ratios


# ----------------------------------------------------------------------
# which backward serves a call
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,w_dtype,hd,s,variant", [
    (torch.bfloat16, torch.float32, 64, 4096, "backward_chunked"),
    (torch.bfloat16, torch.bfloat16, 64, wkvk.CHUNKED_MIN_SEQ, "backward_chunked"),
    (torch.bfloat16, torch.float32, 64, wkvk.CHUNKED_MIN_SEQ - 1, "backward"),
    (torch.bfloat16, torch.float32, 64, 1, "backward"),
    (torch.bfloat16, torch.float32, 32, 4096, "backward"),
    (torch.float32, torch.float32, 64, 4096, "backward"),
    (torch.bfloat16, torch.float16, 64, 4096, "backward")])
def test_backward_variant_follows_the_forward(dtype, w_dtype, hd, s, variant):
    assert wkvk.backward_variant(dtype, w_dtype, hd, s) == variant
    fwd = wkvk.kernel_variant(dtype, w_dtype, hd, s)
    assert (fwd == "chunked") == (variant == "backward_chunked")
    assert variant in wkvk.VARIANTS
