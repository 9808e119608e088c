"""The WKV recurrence's gradient on the port.

Three things are held here, on the CPU, with inputs from numpy seeds and
the decay w drawn per element in [e^-8, 1):

* ``wkv_bhsd`` on CPU tensors (the plain forward, which autograd
  differentiates) and ``ops.rwkv_wkv`` on model-layout views against
  ``jax.grad`` of the JAX model's ``wkv_scan_ref`` and ``wkv_chunked``,
  for r, k, v, w, u and s0.  Against the scan: every gradient within
  ``_JAX_SCAN_TOL`` of its largest magnitude (both sides are f32
  recurrences summed in other orders; bf16 inputs round the gradients
  of r, k and v once more, so 2e-2, ``tests/test_torch_wkv.py``'s bf16
  bar).  Against the chunked form, whose decays go through exp and log
  around each chunk's midpoint: 1e-3, above ``tests/test_wkv_chunked.py``'s
  5e-4 on the outputs.  w stays above e^-7.9 there, so that the chunked
  form's clamp of log w at -8 is inactive and both compute one function.
* ``wkv_bhsd_bwd_plain``, the backward kernel's arithmetic in torch
  (checkpointed states recomputed a chunk at a time, dw from the states,
  rows and columns), against autograd of an f64 oracle, at the test
  shapes, at S = 1024 under the model's law of w and at S = 4096 with
  every w near e^-8: within a quarter of the card's limit.
* The card's limit itself (``BWD_REL`` below, which ``chip_smoke.py``
  and ``tests/test_torch_kernels_cuda.py`` use): 25x the spread of autograd
  of the f32 plain version from the f64 oracle, which this file
  measures.  The same limit rejects a backward that drops one step of
  dout, and the design the kernel did not take (dw from suffix sums of
  per-step terms, divided by w) misses it at S = 4096.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.kernels import rwkv_wkv, wkv_bhsd, wkv_bhsd_plain

wkvk = importlib.import_module("repro_torch.kernels.rwkv_wkv")

GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
# f32 spread of autograd of the plain version from the f64 oracle, as
# measured by test_f32_spread_sets_the_card_limit (largest over its cases
# and gradients, relative to each gradient's largest magnitude), and the
# card's limit: 25x that, by gradient (du is a sum over B*S steps)
SPREAD = {"du": 2e-6, "other": 2.5e-7}
BWD_REL = {"du": 5e-5, "other": 6.25e-6}
_JAX_SCAN_TOL = {"f32": 1e-5, "bf16": 2e-2}
_JAX_CHUNKED_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The recurrences here are thousands of tiny torch operations, one
    step each.  Beside other test processes, torch's intra-op threads only
    contend for the cores (a 4096-step case took minutes), so each test
    runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, s, h, hd, seed, w_law="model", layout="bhsd", dtype=np.float64):
    """r, k, v, w, u, s0, dout, dsT as numpy; r/k/v/w/dout in ``layout``.

    w laws: "model" exp(-min(exp(N(0,1)), 7.9)) (the model's law, kept off
    the chunked form's clamp at e^-8), "uniform" U(0.2, 0.95), "tiny"
    exp(-U(7.5, 8)) (every decay near e^-8, the model's floor)."""
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
    """The recurrence in f64, [B,H,S,hd]: ``reference_wkv`` without its
    upcast to f32."""
    state, outs = s0, []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], state + u[None, :, :, None] * kv))
        state = state * w[:, :, t, :, None] + kv
    return torch.stack(outs, dim=2), state


def _autograd(fn, args, dout, dsT):
    """The six gradients of sum(out * dout) + sum(sT * dsT) by autograd."""
    leaves = [x.detach().clone().requires_grad_() for x in args]
    out, sT = fn(*leaves)
    loss = (out.float() * dout.float()).sum()
    if dsT is not None:
        loss = loss + (sT * dsT).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(x) if g is None else g
            for n, x, g in zip(GRADS, leaves, grads)}


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def _limit_ratio(name, got, ref) -> float:
    """The card's criterion: |got - ref| / (BWD_REL max|ref| + rtol |ref|),
    rtol one bf16 ulp for a bf16 gradient."""
    rel = BWD_REL["du" if name == "du" else "other"]
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, ref = got.double(), ref.double()
    scale = rel * ref.abs().max().clamp(min=1e-300)
    return float(((got - ref).abs() / (scale + rtol * ref.abs())).max())


def _f64(args):
    return [torch.from_numpy(x) for x in args]


def _oracle_grads(args64):
    r, k, v, w, u, s0, dout, dsT = args64
    return _autograd(_oracle_f64, (r, k, v, w, u, s0), dout, dsT)


@functools.lru_cache(maxsize=None)
def _case(b, s, h, hd, w_law):
    """(f64 numpy inputs, the oracle's gradients) of one case, computed
    once for the tests that share it (S = 4096 takes seconds)."""
    args = _inputs(b, s, h, hd, seed=s + hd, w_law=w_law)
    return args, _oracle_grads(_f64(args))


# ----------------------------------------------------------------------
# the CPU Function (plain forward + autograd) against jax.grad
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


# (b, s, h, hd, with s0 and dsT, dtype, JAX function): f32 and bf16, with
# and without the state, ragged S, hd 8-64
_JAX_CASES = [(1, 16, 1, 8, False, "f32", "wkv_scan_ref"),
              (2, 37, 2, 16, True, "f32", "wkv_scan_ref"),
              (2, 5, 3, 32, True, "bf16", "wkv_scan_ref"),
              (1, 64, 4, 64, False, "bf16", "wkv_scan_ref"),
              (1, 16, 1, 8, True, "f32", "wkv_chunked"),
              (2, 37, 2, 16, False, "f32", "wkv_chunked"),
              (1, 64, 4, 64, True, "f32", "wkv_chunked"),
              (2, 37, 2, 16, True, "bf16", "wkv_chunked"),
              (2, 5, 3, 32, False, "bf16", "wkv_chunked")]


@pytest.mark.parametrize("b,s,h,hd,with_state,dtype,jax_fn", _JAX_CASES)
def test_cpu_function_matches_jax_grad(b, s, h, hd, with_state, dtype, jax_fn):
    """ops.rwkv_wkv on model-layout tensors (strided [B,H,S,hd] views into
    wkv_bhsd) against jax.grad.  bf16: bf16 r/k/v/u with f32 w, the
    model's mix."""
    args = _inputs(b, s, h, hd, seed=s * hd + with_state, layout="bshd",
                   dtype=np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    r, k, v, w, u, s0, dout, dsT = (torch.from_numpy(x) for x in args)
    leaves = [r.to(tdt), k.to(tdt), v.to(tdt), w, u.to(tdt), s0]
    leaves = [x.clone().requires_grad_() for x in leaves]
    out, sT = rwkv_wkv(*leaves[:5], leaves[5] if with_state else torch.zeros_like(s0)
                       .requires_grad_())
    loss = (out.float() * dout).sum() + ((sT * dsT).sum() if with_state else 0.0)
    got = torch.autograd.grad(loss, leaves[:5] + ([leaves[5]] if with_state else []))
    ref = _jax_grads(getattr(jrwkv, jax_fn), args, with_state, jdt)
    for name, g in zip(GRADS, got):
        assert g.dtype == leaves[GRADS.index(name)].dtype
        tol = _JAX_SCAN_TOL[dtype] if jax_fn == "wkv_scan_ref" else _JAX_CHUNKED_TOL
        if dtype == "bf16" and name in ("dr", "dk", "dv", "du"):
            tol = max(tol, _JAX_SCAN_TOL["bf16"])
        err = _rel(g.float(), torch.from_numpy(ref[name].copy()))
        assert err <= tol, (name, err)


def test_cpu_function_launches_nothing_and_grads_every_input():
    args = _inputs(2, 24, 2, 16, seed=4, dtype=np.float32)
    total = wkv_bhsd.launches
    got = _autograd(wkv_bhsd, [torch.from_numpy(x) for x in args[:6]],
                    torch.from_numpy(args[6]), torch.from_numpy(args[7]))
    assert wkv_bhsd.launches == total
    assert all(bool(g.abs().max() > 0) for g in got.values())


# ----------------------------------------------------------------------
# the backward kernel's arithmetic, and the card's limit
# ----------------------------------------------------------------------
_ORACLE_CASES = [(1, 16, 1, 8, "uniform"), (2, 37, 2, 16, "model"), (1, 64, 4, 64, "model"),
                 (2, 33, 2, 32, "tiny"), (1, 1024, 2, 64, "model"),
                 (1, 4096, 1, 64, "tiny")]


@pytest.mark.parametrize("b,s,h,hd,w_law", _ORACLE_CASES)
def test_plain_backward_matches_f64_autograd(b, s, h, hd, w_law):
    """wkv_bhsd_bwd_plain in f32 within a quarter of the card's limit of
    the f64 oracle's gradients; below S = 1024 also with bf16 r/k/v and
    dout (f32 w), whose bf16 gradients may take half of the limit by their
    own rounding (half an ulp)."""
    args, ref = _case(b, s, h, hd, w_law)
    dtypes = (torch.float32,) if s >= 1024 else (torch.float32, torch.bfloat16)
    for dtype in dtypes:
        r, k, v, w, u, s0, dout, dsT = (torch.from_numpy(x).float() for x in args)
        r, k, v, dout = (x.to(dtype) for x in (r, k, v, dout))
        if dtype == torch.bfloat16:      # the oracle at the rounded inputs
            ref = _oracle_grads([x.double() for x in (r, k, v, w, u, s0, dout, dsT)])
        got = dict(zip(GRADS, wkvk.wkv_bhsd_bwd_plain(r, k, v, w, u, s0, dout, dsT)))
        for name in GRADS:
            assert got[name].dtype == (dtype if name in ("dr", "dk", "dv") else torch.float32)
            quota = 0.5 if got[name].dtype == torch.bfloat16 else 0.25
            ratio = _limit_ratio(name, got[name], ref[name])
            assert ratio <= quota, (dtype, name, ratio)


@pytest.mark.parametrize("s", [1, 15, 16, 17, 50])
def test_plain_backward_without_dsT_at_chunk_edges(s):
    """S at and around the 16-step checkpoint interval, dsT absent (the
    model drops sT)."""
    args = _inputs(2, s, 2, 8, seed=s, w_law="uniform")
    r, k, v, w, u, s0, dout, _ = _f64(args)
    ref = _autograd(_oracle_f64, (r, k, v, w, u, s0), dout, None)
    got = wkvk.wkv_bhsd_bwd_plain(*(x.float() for x in (r, k, v, w, u, s0, dout)))
    for name, g in zip(GRADS, got):
        assert _limit_ratio(name, g, ref[name]) <= 0.25, name


@pytest.mark.parametrize("b,s,h,hd,w_law", _ORACLE_CASES)
def test_f32_spread_sets_the_card_limit(b, s, h, hd, w_law):
    """Autograd of the f32 plain version stays within SPREAD of the f64
    oracle, and BWD_REL is 25x SPREAD."""
    args, ref = _case(b, s, h, hd, w_law)
    a32 = [torch.from_numpy(x).float() for x in args]
    got = _autograd(wkv_bhsd_plain, a32[:6], a32[6], a32[7])
    for name in GRADS:
        key = "du" if name == "du" else "other"
        assert _rel(got[name], ref[name]) <= SPREAD[key], name
        assert BWD_REL[key] == pytest.approx(25 * SPREAD[key])


@pytest.mark.parametrize("w_law", ["model", "tiny"])
def test_limit_rejects_a_dropped_step(w_law):
    """The plain gradients with one late dout step zeroed (what a backward
    that loses a step would give) fail the card's limit."""
    args = _inputs(1, 256, 2, 32, seed=9, w_law=w_law, dtype=np.float32)
    a = [torch.from_numpy(x) for x in args]
    ref = _autograd(wkv_bhsd_plain, a[:6], a[6], a[7])
    bad_dout = a[6].clone()
    bad_dout[:, :, 192] = 0
    bad = _autograd(wkv_bhsd_plain, a[:6], bad_dout, a[7])
    assert max(_limit_ratio(n, bad[n], ref[n]) for n in GRADS) > 1e3


def _suffix_sum_dw(r, k, v, w, u, s0, dout, dsT):
    """dw by the identity w_t dw_t = sum_{s>t} a_s - sum_{s>=t} b_s (with
    a_s = r_s.(S_s dout_s) plus the end term rowsum(S_S * dsT), and
    b_s = k_s.(G_{s+1} v_s)): no states kept, f32 terms summed in f64."""
    state, a = s0, []
    for t in range(r.shape[2]):
        a.append((r[:, :, t] * (state @ dout[:, :, t, :, None])[..., 0]).double())
        state = w[:, :, t, :, None] * state + k[:, :, t, :, None] * v[:, :, t, None, :]
    a.append((state * dsT).sum(-1).double())
    g, b = dsT, []
    for t in reversed(range(r.shape[2])):
        b.append((k[:, :, t] * (g @ v[:, :, t, :, None])[..., 0]).double())
        g = w[:, :, t, :, None] * g + r[:, :, t, :, None] * dout[:, :, t, None, :]
    a, b = torch.stack(a, dim=2), torch.stack(b[::-1], dim=2)
    later_a = torch.flip(torch.cumsum(torch.flip(a, [2]), 2), [2])[:, :, 1:]
    from_b = torch.flip(torch.cumsum(torch.flip(b, [2]), 2), [2])
    return ((later_a - from_b) / w.double()).float()


def test_suffix_sum_dw_misses_the_limit():
    """The design the kernel did not take: dw from suffix sums of per-step
    terms needs no stored states, but at S = 4096 with every w near e^-8
    it misses the card's limit more than 100-fold (the kernel's recompute
    meets it: above)."""
    args, ref = _case(1, 4096, 1, 64, "tiny")
    dw = _suffix_sum_dw(*(torch.from_numpy(x).float() for x in args))
    assert _limit_ratio("dw", dw, ref["dw"]) > 100
