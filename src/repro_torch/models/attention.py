"""Grouped-query attention — port of ``repro/models/attention.py``.

* :func:`gqa_attention` — self-attention over a full sequence
  (prefill).  On CUDA tensors it runs the Hopper flash kernel through
  :func:`repro_torch.kernels.ops.flash_attention`; on CPU tensors it
  runs the ported online-softmax scan (:func:`_chunked_gqa` /
  :func:`_chunked_mha`), so the CPU numerics are the JAX model's.
* :func:`decode_attention` — one new query against a KV cache, plain
  torch like the JAX package's jnp code.
* :func:`cross_attention` — queries attend to a fixed memory (VLM
  frontend tokens / encoder output): the chunked scan on every device.

The JAX code asks its dots for f32 results
(``preferred_element_type``); here that is an f32 product of the
operands upcast to f32, which is exact for bf16 inputs.  As in JAX, each
KV chunk of the scan is checkpointed under grad: the backward pass
recomputes a chunk's scores and probabilities instead of saving them.
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

__all__ = ["gqa_attention", "decode_attention", "cross_attention", "repeat_kv"]

_NEG_INF = -1e30


def repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Hkv, hd] -> [B, S, Hkv*groups, hd]."""
    if groups == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def _pad_chunks(k, v, chunk):
    b, sk, h, hd = k.shape
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return (k.reshape(b, n_chunks, chunk, h, hd),
            v.reshape(b, n_chunks, chunk, h, hd), n_chunks)


def _chunk_mask(start, chunk, sk, q_pos, causal, sliding_window):
    k_pos = start + torch.arange(chunk, device=q_pos.device)
    mask = (k_pos[None, :] < sk).expand(q_pos.shape[0], chunk)   # padding
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if sliding_window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
    return mask                                                  # [Sq, chunk]


def _scan_chunks(step, carry, kc, vc, n_chunks):
    """``carry = step(carry, kb, vb, c)`` over the KV chunks, each chunk
    checkpointed under grad (``jax.checkpoint`` on the JAX scan's body)."""
    for c in range(n_chunks):
        if torch.is_grad_enabled():
            carry = checkpoint(step, carry, kc[:, c], vc[:, c], c, use_reentrant=False)
        else:
            carry = step(carry, kc[:, c], vc[:, c], c)
    return carry


def _chunked_mha(q, k, v, *, causal: bool, chunk: int,
                 sliding_window: int = 0, q_offset: int = 0):
    """Online-softmax attention, scanning over KV chunks.

    q: [B, Sq, H, hd]; k, v: [B, Sk, H, hd].  Returns [B, Sq, H, hd].
    ``q_offset`` is the absolute position of q[0] (prefill: 0).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qs = (q * (hd ** -0.5)).float()   # scaled in the input dtype, as JAX
    kc, vc, n_chunks = _pad_chunks(k, v, chunk)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    def step(carry, kb, vb, c):
        m, l, acc = carry
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kb.float())
        mask = _chunk_mask(c * chunk, chunk, sk, q_pos, causal, sliding_window)
        s = torch.where(mask[None, None], s, s.new_tensor(_NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # p is rounded to V's dtype before the PV dot, as JAX does
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
        return m_new, l, acc * corr[..., None] + pv

    m, l, acc = _scan_chunks(step, (torch.full((b, h, sq), _NEG_INF, device=q.device),
                                    torch.zeros((b, h, sq), device=q.device),
                                    torch.zeros((b, h, sq, hd), device=q.device)),
                             kc, vc, n_chunks)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                      # [B, Sq, H, hd]


def _chunked_gqa(q, k, v, *, causal: bool, chunk: int,
                 sliding_window: int = 0):
    """Grouped online-softmax attention.

    q: [B, Sq, Hkv, G, hd]; k, v: [B, Sk, Hkv, hd].
    Returns [B, Sq, Hkv, G, hd].
    """
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    qs = (q * (hd ** -0.5)).float()
    kc, vc, n_chunks = _pad_chunks(k, v, chunk)
    q_pos = torch.arange(sq, device=q.device)

    def step(carry, kb, vb, c):
        m, l, acc = carry
        s = torch.einsum("bqhgd,bkhd->bhqgk", qs, kb.float())
        mask = _chunk_mask(c * chunk, chunk, sk, q_pos, causal, sliding_window)
        s = torch.where(mask[None, None, :, None, :], s, s.new_tensor(_NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqgk,bkhd->bhqgd", p.to(vb.dtype).float(), vb.float())
        return m_new, l, acc * corr[..., None] + pv

    m, l, acc = _scan_chunks(step, (torch.full((b, hkv, sq, g), _NEG_INF, device=q.device),
                                    torch.zeros((b, hkv, sq, g), device=q.device),
                                    torch.zeros((b, hkv, sq, g, hd), device=q.device)),
                             kc, vc, n_chunks)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).to(q.dtype)     # [B, Sq, Hkv, G, hd]


def gqa_attention(q, k, v, *, causal: bool = True, chunk: int = 512,
                  sliding_window: int = 0) -> torch.Tensor:
    """Self-attention; q [B,S,Hq,hd], k/v [B,S,Hkv,hd].

    CPU tensors run the chunked scan (``chunk`` is its KV chunk).  Other
    devices run the Hopper kernel, which has no sliding window.  A window
    of at least S masks no key (every key k of query q has k > q - S), so
    the kernel computes the same function there; a window shorter than S
    raises rather than silently attending to the whole prefix.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if q.device.type != "cpu":
        if 0 < sliding_window < s:
            raise NotImplementedError(
                f"the Hopper flash kernel has no sliding window; a window of "
                f"{sliding_window} < S = {s} waits for a kernel that masks it")
        return ops.flash_attention(q, k, v, causal=causal)
    groups = hq // hkv
    chunk = min(chunk, s)
    if groups == 1:
        return _chunked_mha(q, k, v, causal=causal, chunk=chunk,
                            sliding_window=sliding_window)
    qg = q.reshape(b, s, hkv, groups, hd)
    og = _chunked_gqa(qg, k, v, causal=causal, chunk=chunk,
                      sliding_window=sliding_window)
    return og.reshape(b, s, hq, hd)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sliding_window: int = 0) -> torch.Tensor:
    """One-step attention: q [B,1,Hq,hd] vs cache [B,Smax,Hkv,hd].

    ``cache_len`` — number of valid cache entries, an int or a ``[B]``
    tensor of per-slot lengths (the new token's KV must already be
    written at ``cache_len - 1``).  The GQA grouping is folded into the
    dots; the cache is never repeated across query heads.

    The cache may hold another dtype than q (an f32 cache under a bf16
    model): like jnp's promotion, the dots run in f32 and the output
    comes back in q's dtype.
    """
    b, one, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q * (hd ** -0.5)).reshape(b, one, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhqgk", qg.float(), k_cache.float())
    k_pos = torch.arange(smax, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.dim() == 0:
        clen = clen.expand(b)
    mask = k_pos[None, :] < clen[:, None]                        # [B, Smax]
    if sliding_window > 0:
        mask = mask & (k_pos[None, :] > clen[:, None] - 1 - sliding_window)
    s = torch.where(mask[:, None, None, None, :], s, s.new_tensor(_NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqgk,bkhd->bhqgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.permute(0, 2, 1, 3, 4).reshape(b, one, hq, hd).to(q.dtype)


def cross_attention(q, k, v, chunk: int = 512) -> torch.Tensor:
    """Non-causal attention of q [B,Sq,Hq,hd] over memory k/v [B,Sm,Hkv,hd].

    The chunked scan (``chunk`` is its KV chunk) on every device: no TPU
    kernel computes attention over a memory of another length than the
    queries (the Pallas kernel and the port's Hopper kernel take one S for
    q and k), so the JAX model runs its jnp scan here too.
    """
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    chunk = min(chunk, k.shape[1])
    if groups == 1:
        return _chunked_mha(q, k, v, causal=False, chunk=chunk)
    qg = q.reshape(b, sq, hkv, groups, hd)
    og = _chunked_gqa(qg, k, v, causal=False, chunk=chunk)
    return og.reshape(b, sq, hq, hd)
