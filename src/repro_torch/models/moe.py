"""Mixture-of-Experts FFN — port of ``repro/models/moe.py``.

Capacity-based expert-choice routing, as in the JAX function: tokens are
routed per *group* (``x`` is ``[G, T, d]``: one sequence a group for
training and prefill, one token a group for decode), every token picks
its top-k experts (gates renormalised), then every expert takes its top-C
tokens by gate value (C = :func:`moe_capacity`), runs a batched SwiGLU on
them, and the gated outputs go back to their tokens.  Tokens over an
expert's capacity are dropped by that expert.

Where the JAX code leaves an order to the backend, the port fixes it:

* Both top-k steps are a stable descending sort, sliced: on ties the
  lower index comes first, as ``jax.lax.top_k`` puts it.  Ties are
  common: the expert-choice scores are mostly exact zeros.
* The combine is a gather, not a scatter-add: each token reads the
  outputs of its own top-k choices through the inverse of the expert's
  selection (token, choice) -> (expert, slot) and sums them, so the card
  needs no float atomics and two calls give the same bits.  The k
  outputs are summed in f32 and rounded once to ``x.dtype`` (JAX adds
  them in ``x.dtype`` in scatter order); in f32 the two differ by
  summation order alone.

The expert products are batched matmuls over the expert dim, as in JAX,
where they run outside any Pallas kernel; the port adds no kernel here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["MoeRoute", "init_moe", "moe_capacity", "moe_ffn", "moe_route"]


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = int(tokens_per_group * top_k * capacity_factor / n_experts)
    return max(1, min(c, tokens_per_group))


def init_moe(init, d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": init.normal((d_model, n_experts), fan_in=d_model),
        "w_gate": init.normal((n_experts, d_model, d_ff), fan_in=d_model),
        "w_up": init.normal((n_experts, d_model, d_ff), fan_in=d_model),
        "w_down": init.normal((n_experts, d_ff, d_model), fan_in=d_ff),
    }


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values, ties in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclass
class MoeRoute:
    """One call's routing.  ``probs`` [G,T,E] f32 router softmax;
    ``top_idx`` [G,T,k] each token's experts, best first; ``routed``
    [G,T,E] f32 gates (0 off a token's top-k); ``sel_vals``/``sel_tok``
    [G,E,C] each expert's gates and tokens, best first (a gate of 0 marks
    an empty slot)."""
    probs: torch.Tensor
    top_idx: torch.Tensor
    routed: torch.Tensor
    sel_vals: torch.Tensor
    sel_tok: torch.Tensor

    def dropped(self) -> int:
        """(token, expert) pairs with a gate that no expert slot took."""
        return int((self.routed > 0).sum() - (self.sel_vals > 0).sum())


def moe_route(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> MoeRoute:
    """Token choice, then expert choice with capacity, for ``x`` [G,T,d]."""
    g, t, _ = x.shape
    e = params["router"].shape[1]
    cap = moe_capacity(t, e, top_k, capacity_factor)
    # the logits in x's dtype, then widened, as the JAX function does
    logits = x @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)                # [G,T,E]
    # token-choice top-k, renormalised (Mixtral convention)
    top_vals, top_idx = _top_k(probs, top_k)                     # [G,T,k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    routed = torch.zeros((g, t, e), dtype=torch.float32, device=x.device)
    routed = routed.scatter(-1, top_idx, top_vals)               # [G,T,E]
    # expert-choice capacity selection: each expert its top-C tokens
    sel_vals, sel_tok = _top_k(routed.transpose(1, 2), cap)      # [G,E,C]
    return MoeRoute(probs, top_idx, routed, sel_vals, sel_tok)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25,
            shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN to ``x`` [G,T,d].  Returns ``(y, aux_loss)``:
    ``y`` [G,T,d] in x's dtype and the Switch load-balancing loss (f32
    scalar, mean over groups).  ``shard(tensor, kind)`` is called where the
    JAX function pins its gather intermediates ("moe_tokens",
    "moe_hidden"); the default is the identity."""
    shard = shard or (lambda v, kind: v)
    g, t, d = x.shape
    e = params["router"].shape[1]
    route = moe_route(params, x, top_k=top_k, capacity_factor=capacity_factor)
    sel_vals, sel_tok = route.sel_vals, route.sel_tok
    cap = sel_tok.shape[-1]
    weights = (sel_vals * (sel_vals > 0.0)).to(x.dtype)          # [G,E,C]

    # token activations per expert slot [G,E,C,d], an index into x
    rows = torch.arange(g, device=x.device)[:, None, None]
    xs = shard(x[rows, sel_tok], "moe_tokens")

    # batched SwiGLU over experts
    h_gate = torch.einsum("gecd,edf->gecf", xs, params["w_gate"].to(x.dtype))
    h_up = torch.einsum("gecd,edf->gecf", xs, params["w_up"].to(x.dtype))
    h = shard(F.silu(h_gate) * h_up, "moe_hidden")
    ys = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(x.dtype))
    ys = shard(ys * weights[..., None], "moe_tokens")

    # combine: slot[g, e, t] is the slot where expert e took token t (cap
    # where it did not); each token gathers its k choices' slots and sums
    slot = torch.full((g, e, t), cap, dtype=torch.long, device=x.device)
    slot.scatter_(2, sel_tok, torch.arange(cap, device=x.device).expand(g, e, cap))
    expert = route.top_idx                                       # [G,T,k]
    tok = torch.arange(t, device=x.device)[None, :, None]
    taken = slot[rows, expert, tok]                              # [G,T,k]
    picked = ys.reshape(g, e * cap, d)[rows, expert * cap + taken.clamp(max=cap - 1)]
    picked = torch.where((taken < cap)[..., None], picked, picked.new_zeros(()))
    y = picked.float().sum(dim=2).to(x.dtype)

    # Switch load-balancing loss: E * sum_e f_e * p_e
    frac_routed = (route.routed > 0).float().mean(dim=1)         # [G,E]
    mean_prob = route.probs.mean(dim=1)                          # [G,E]
    aux = e * torch.mean(torch.sum(frac_routed * mean_prob, dim=-1))
    return y, aux
