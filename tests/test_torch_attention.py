"""Port parity: attention.

The port's plain kernel version and ``ops.flash_attention`` on the CPU
vs the JAX Pallas kernel in interpret mode; the port's oracle, model
attention and decode attention vs their JAX counterparts.  Inputs come
from numpy seeds.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 in f32 (summation order), 2e-2 in bf16 (one output rounding).

The bf16 rounding of the kernel family (q, k, v upcast to f32) differs
from the model family's (q scaled in bf16, p cast to V's dtype), so each
port is held against its own family only.
"""
import ctypes
import os
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import reference_attention as jax_reference
from repro.models import attention as jattn
from repro_torch.kernels import (flash_attention, flash_attention_bhsd,
                                 flash_attention_bhsd_plain,
                                 reference_attention)
from repro_torch.models import attention as tattn

_SHAPES = [
    (1, 32, 2, 2, 16),     # MHA
    (2, 64, 4, 2, 32),     # GQA 2:1
    (1, 128, 8, 1, 64),    # MQA
    (2, 48, 4, 4, 128),    # uneven S vs block, MXU-width head
]
_TOL = {np.float32: 2e-5, "bf16": 2e-2}


def _qkv(b, s, h, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32))


def _bhsd(x):
    b, s, h, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,hkv,hd", _SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_ops_match_jax_kernel(b, s, h, hkv, hd, causal):
    q, k, v = _qkv(b, s, h, hkv, hd, seed=b * s + h)
    o_jax = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, block_q=16, block_k=16,
                                 interpret=True))
    o_ops = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(o_ops, o_jax, 2e-5)
    o_plain = flash_attention_bhsd_plain(_t(_bhsd(q)), _t(_bhsd(k)),
                                         _t(_bhsd(v)), causal=causal)
    _close(o_plain, _bhsd(o_jax), 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_jax_kernel(causal):
    q, k, v = _qkv(2, 32, 4, 2, 32, seed=7)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_jax = jax_flash(qb, kb, vb, causal=causal, block_q=16, block_k=16,
                      interpret=True)
    to_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    o = flash_attention(to_t(qb), to_t(kb), to_t(vb), causal=causal)
    assert o.dtype == torch.bfloat16
    _close(o, o_jax.astype(jnp.float32), 2e-2)


@pytest.mark.parametrize("b,s,h,hkv,hd", _SHAPES[1:3])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(b, s, h, hkv, hd, causal):
    q, k, v = (_bhsd(x) for x in _qkv(b, s, h, hkv, hd, seed=11))
    o_t = reference_attention(_t(q), _t(k), _t(v), causal=causal)
    o_j = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
    _close(o_t, o_j, 2e-5)


def _with_mkl_verbose(fn):
    """(fn(), what MKL's verbose mode printed during it): the library
    calls, with their code path, that the port's einsums made.  MKL writes
    to file descriptor 1 through C's stdio, so that descriptor is sent to a
    file for the call and C's buffers are flushed before it is restored."""
    with tempfile.TemporaryFile(mode="w+") as log:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            with torch.backends.mkl.verbose(torch.backends.mkl.VERBOSE_ON):
                out = fn()
        finally:
            ctypes.CDLL(None).fflush(None)
            os.dup2(saved, 1)
            os.close(saved)
        log.seek(0)
        return out, log.read()


@pytest.mark.parametrize("b,s,h,hkv,hd,chunk,window", [
    (2, 64, 4, 2, 32, 16, 0),      # GQA, several chunks
    (1, 48, 4, 4, 16, 16, 0),      # MHA path
    (2, 40, 6, 2, 16, 16, 0),      # ragged last chunk
    (1, 64, 4, 1, 32, 16, 12),     # MQA with a sliding window
])
def test_gqa_attention_matches_jax(b, s, h, hkv, hd, chunk, window):
    q, k, v = _qkv(b, s, h, hkv, hd, seed=s + hd)
    def port():
        return tattn.gqa_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                   sliding_window=window).numpy()

    def jax():
        return np.asarray(jattn.gqa_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk,
            sliding_window=window))

    # MKL's record of the first port call, shown only on a failure
    o_t, mkl_log = _with_mkl_verbose(port)
    o_j = jax()
    assert o_t.shape == o_j.shape
    over = ~np.isclose(o_t, o_j, atol=2e-5, rtol=2e-5)
    if over.any():
        # an intermittent mismatch is open (ROADMAP queue 3): say which
        # side gives another answer on a second reading, where, and
        # whether the port's second reading meets the bar
        o_t2, o_j2 = port(), jax()
        rows = sorted({tuple(i[:3]) for i in np.argwhere(over).tolist()})
        pytest.fail(f"{over.sum()} elements over 2e-5, max diff "
                    f"{np.abs(o_t - o_j).max()}, first at "
                    f"{np.argwhere(over)[:8].tolist()}, (b, s, h) rows {rows[:12]}; "
                    f"second reading equal: port {np.array_equal(o_t2, o_t)}, "
                    f"jax {np.array_equal(o_j2, o_j)}; port's second reading "
                    f"within 2e-5 of jax: {np.allclose(o_t2, o_j, atol=2e-5, rtol=2e-5)}, "
                    f"the port's two readings differ by {np.abs(o_t2 - o_t).max()}; "
                    f"torch threads {torch.get_num_threads()}; MKL verbose of the first "
                    f"port call:\n{mkl_log[:4000]}")


@pytest.mark.parametrize("cache_len", [9, np.array([1, 17, 32])])
def test_decode_attention_matches_jax(cache_len):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 1, 4, 32)).astype(np.float32)
    kc = rng.normal(size=(3, 32, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(3, 32, 2, 32)).astype(np.float32)
    o_t = tattn.decode_attention(_t(q), _t(kc), _t(vc), torch.as_tensor(cache_len))
    o_j = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(cache_len))
    _close(o_t, o_j, 2e-5)


def test_decode_attention_bf16_query_f32_cache():
    """ServeLoop's f32 cache under a bf16 model: jnp promotes the dots to
    f32 and returns q's dtype; the port casts to match."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    o_j = jattn.decode_attention(qj, jnp.asarray(kc), jnp.asarray(vc), 5)
    qt = torch.from_numpy(np.asarray(qj, np.float32)).to(torch.bfloat16)
    o_t = tattn.decode_attention(qt, _t(kc), _t(vc), 5)
    assert o_t.dtype == torch.bfloat16
    _close(o_t, o_j.astype(jnp.float32), 2e-2)


def test_repeat_kv():
    x = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    out = tattn.repeat_kv(x, 3)
    ref = jattn.repeat_kv(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_head_ratio_error():
    q, k, v = (torch.zeros(n, 8, 16) for n in (3, 2, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention_bhsd(q, k, v)


def test_sliding_window_on_a_card_tensor_raises():
    q = torch.empty(1, 8, 4, 128, device="meta")
    kv = torch.empty(1, 8, 2, 128, device="meta")
    with pytest.raises(NotImplementedError, match="sliding window"):
        tattn.gqa_attention(q, kv, kv, sliding_window=4)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Meta tensors (the dry run) take the kernel's meta branch, never the
    plain version, and launch nothing; tensors on two devices raise."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(fa, "flash_attention_bhsd_plain", plain)
    q = torch.empty(4, 8, 128, device="meta")
    kv = torch.empty(2, 8, 128, device="meta")
    fa.reset_launch_counts()
    out = flash_attention_bhsd(q, kv, kv)
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype, "meta")
    assert fa.flash_attention_bhsd.launches == 0
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bhsd(q, torch.zeros(2, 8, 128), torch.zeros(2, 8, 128))


def test_kernel_builds_for_sm90a_into_the_ignored_build_dir():
    from repro_torch.kernels import _build
    src, lib = _build._paths("flash_attention")
    assert src.is_file() and src.parent == _build.CSRC
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    repo = Path(__file__).resolve().parents[1]
    assert lib.parent == repo / "build" / "repro_torch_kernels"
    assert "build/" in (repo / ".gitignore").read_text().split()
