"""Plain float32 reference of the benchmark's MoE decoders.

Written from the published models (OLMoE, arXiv:2409.02060; Mixtral,
arXiv:2401.04088): pre-norm RMSNorm blocks, rotary position embeddings
(the rotate-half form, angles in float64), causal grouped-query softmax
attention, and a SwiGLU mixture of experts; with the port's documented
MoE semantics where they depart from the papers: each sequence is a
routing group, every token takes its top-k experts by softmax
probability (ties to the lower index) and renormalises their gates, then
every expert keeps its ``int(T * k * capacity_factor / E)`` tokens of
highest gate (ties to the lower token) and drops the rest; the Switch
load-balancing loss of each layer is added to the training loss at 0.01.

Weights are drawn from the seed by :mod:`chipbench.weights`, layer by
layer, in the served type, then widened to float32.  Everything else is
float32 with TF32 off.  Nothing here imports the program.

``lowp`` names a lower precision to compute every matrix product's
operands in: ``"fp8"`` rounds both operands to float8 e4m3 with a
per-tensor scale (the benchmark's control), ``"bf16"`` to bfloat16 (a
witness at the program's own precision); None is float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from chipbench import weights

__all__ = ["Reference", "exact_float32", "lowp_round"]

_E4M3_MAX = 448.0


def exact_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def lowp_round(x: torch.Tensor, lowp: str | None) -> torch.Tensor:
    """``x`` rounded to ``lowp`` and back to float32 (None: ``x``).  The
    gradient passes straight through the rounding."""
    if lowp is None:
        return x
    with torch.no_grad():
        if lowp == "bf16":
            q = x.detach().to(torch.bfloat16).to(torch.float32)
        elif lowp == "fp8":
            scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
            q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        else:
            raise ValueError(f"unknown lower precision {lowp!r}")
    return x + (q - x).detach() if x.requires_grad else q


def _rms_norm(x, gain, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain


def _rope_table(hd: int, seq: int, theta: float, device) -> tuple:
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    ang = np.outer(np.arange(seq, dtype=np.float64), inv)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(device)
    return cos, sin


def _rope(x, cos, sin):
    """x [B, S, H, hd]: the first and second halves of each head rotated
    as pairs by the position's angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Reference:
    """The decoder sized by ``m`` (a ``configs/*.json`` ``model``) with the
    weights of ``seed``, on ``device``."""

    def __init__(self, m: dict, seed: int, *, capacity_factor: float, device,
                 weight_dtype=torch.bfloat16, lowp: str | None = None,
                 q_block: int = 1024) -> None:
        self.m = m
        self.seed = seed
        self.cf = capacity_factor
        self.device = torch.device(device)
        self.lowp = lowp
        self.q_block = q_block
        self.hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
        self.dtype = weight_dtype            # the type the weights are drawn in

    # ------------------------------------------------------------------ #
    # weights
    # ------------------------------------------------------------------ #
    def leaf(self, name: str, layer: int | None, shape) -> torch.Tensor:
        return weights.draw(self.seed, name, layer, shape, self.dtype,
                            self.device).to(torch.float32)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights, float32, keyed by their last name part."""
        return {name.rsplit(".", 1)[1] if "moe" not in name else
                "moe_" + name.rsplit(".", 1)[1]: self.leaf(name, i, shape)
                for name, shape in weights.layer_shapes(self.m).items()}

    def top(self) -> dict:
        return {name: self.leaf(name, None, shape)
                for name, shape in weights.top_shapes(self.m).items()}

    # ------------------------------------------------------------------ #
    # blocks
    # ------------------------------------------------------------------ #
    def _mm(self, a, b):
        return lowp_round(a, self.lowp) @ lowp_round(b, self.lowp)

    def attention(self, q, k, v):
        """Causal softmax attention, q [B, S, Hq, hd], k/v [B, S, Hkv, hd];
        query blocks of ``q_block`` rows against the keys they may see."""
        b, s, hq, hd = q.shape
        g = hq // k.shape[2]
        k = k.repeat_interleave(g, dim=2).transpose(1, 2)        # [B, Hq, S, hd]
        v = v.repeat_interleave(g, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        out = []
        for lo in range(0, s, self.q_block):
            hi = min(lo + self.q_block, s)
            scores = self._mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) / math.sqrt(hd)
            keep = (torch.arange(hi, device=q.device)[None, :]
                    <= torch.arange(lo, hi, device=q.device)[:, None])
            scores = scores.masked_fill(~keep, float("-inf"))
            out.append(self._mm(torch.softmax(scores, dim=-1), v[:, :, :hi]))
        return torch.cat(out, dim=2).transpose(1, 2)              # [B, S, Hq, hd]

    def moe(self, h, w):
        """(y, Switch loss) of the capacity-routed SwiGLU experts, each
        sequence of ``h`` [B, T, d] routed on its own."""
        bsz, t, d = h.shape
        e, k = self.m["n_experts"], self.m["experts_per_token"]
        probs = torch.softmax(self._mm(h, w["moe_router"]), dim=-1)          # [B,T,E]
        top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
        top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp(min=1e-9)
        gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)      # [B,T,E]
        cap = max(1, min(int(t * k * self.cf / e), t))
        sel_vals, sel_tok = torch.sort(gates.transpose(1, 2), dim=-1, descending=True,
                                       stable=True)
        sel_vals, sel_tok = sel_vals[..., :cap], sel_tok[..., :cap]         # [B,E,C]
        flat = h.reshape(bsz * t, d)
        rows = (torch.arange(bsz, device=h.device)[:, None] * t)             # [B,1]
        y = torch.zeros_like(flat)
        for j in range(e):
            idx = (rows + sel_tok[:, j]).reshape(-1)                         # [B*C]
            xs = flat[idx]
            hid = (torch.nn.functional.silu(self._mm(xs, w["moe_w_gate"][j]))
                   * self._mm(xs, w["moe_w_up"][j]))
            out = self._mm(hid, w["moe_w_down"][j]) * sel_vals[:, j].reshape(-1, 1)
            y = y.index_add(0, idx, out)
        routed = (gates > 0).float().mean(dim=1)                             # [B,E]
        aux = e * torch.mean(torch.sum(routed * probs.mean(dim=1), dim=-1))
        return y.reshape(bsz, t, d), aux

    def block(self, x, w, cos, sin):
        """One decoder layer: (x, its Switch loss)."""
        m, hd = self.m, self.hd
        b, s, _ = x.shape
        h = _rms_norm(x, w["norm"], m["norm_eps"])
        q = self._mm(h, w["wq"]).reshape(b, s, m["n_heads"], hd)
        k = self._mm(h, w["wk"]).reshape(b, s, m["n_kv_heads"], hd)
        v = self._mm(h, w["wv"]).reshape(b, s, m["n_kv_heads"], hd)
        o = self.attention(_rope(q, cos, sin), _rope(k, cos, sin), v)
        x = x + self._mm(o.reshape(b, s, -1), w["wo"])
        y, aux = self.moe(_rms_norm(x, w["ffn_norm"], m["norm_eps"]), w)
        return x + y, aux

    # ------------------------------------------------------------------ #
    # serving: the last position's logits
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def last_logits(self, prompts: torch.Tensor) -> torch.Tensor:
        """Float32 logits [N, V] of each prompt's last position; prompts
        [N, S] token ids.  Layer by layer over every prompt, each prompt
        its own routing group."""
        m = self.m
        top = self.top()
        cos, sin = _rope_table(self.hd, prompts.shape[1], m["rope_theta"], self.device)
        xs = [top["embed"][prompts[i:i + 1]] for i in range(prompts.shape[0])]
        for layer in range(m["n_layers"]):
            w = self.layer(layer)
            xs = [self.block(x, w, cos, sin)[0] for x in xs]
            del w
        last = torch.cat([x[:, -1] for x in xs])
        return self._mm(_rms_norm(last, top["final_norm"], m["norm_eps"]),
                        top["lm_head"].T)

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def train_params(self) -> dict:
        """Every leaf as a float32 tensor that requires grad, the layer
        leaves stacked over the layers, keyed by tree path."""
        n = self.m["n_layers"]
        params = {name: self.leaf(name, None, shape)
                  for name, shape in weights.top_shapes(self.m).items()}
        for name, shape in weights.layer_shapes(self.m).items():
            stack = torch.empty((n, *shape), dtype=torch.float32, device=self.device)
            for i in range(n):
                stack[i] = self.leaf(name, i, shape)
            params[name] = stack
        for p in params.values():
            p.requires_grad_(True)
        return params

    def _layer_of(self, params: dict, i: int) -> dict:
        return {name.rsplit(".", 1)[1] if "moe" not in name else
                "moe_" + name.rsplit(".", 1)[1]: params[name][i]
                for name in weights.layer_shapes(self.m)}

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross entropy plus 0.01 times the summed Switch
        losses; each layer recomputed in the backward pass."""
        m = self.m
        cos, sin = _rope_table(self.hd, tokens.shape[1], m["rope_theta"], self.device)
        x = params["embed"][tokens]
        aux = 0.0
        for i in range(m["n_layers"]):
            def run(x, *leaves, i=i):
                w = dict(zip(self._layer_of(params, i), leaves))
                return self.block(x, w, cos, sin)
            w = self._layer_of(params, i)
            x, a = checkpoint(run, x, *w.values(), use_reentrant=False)
            aux = aux + a
        h = _rms_norm(x, params["final_norm"], m["norm_eps"])
        logits = self._mm(h, params["lm_head"].T)
        nll = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                labels.reshape(-1))
        return nll + 0.01 * aux
