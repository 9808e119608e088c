"""Model architectures as workflow DAGs — the bridge between the
assigned architectures and the paper's scheduler.

Every (ModelConfig × ShapeConfig) lowers to a :class:`Workflow` whose
tasks are the model's macro-ops (embedding, per-layer mixers/FFNs,
individual experts, frontend/encoder, LM head):

* ``w_u``   — analytic FLOPs of the op under the shape,
* ``m_u``   — bytes resident while the op runs (weights + working set;
  decode adds the op's KV/state cache),
* ``c_uv``  — activation bytes flowing between ops (residual streams,
  routed expert tokens, cross-attention memories).

MoE experts become *individual parallel tasks*, so DagHetPart's
partitioning of the graph performs expert placement as a by-product —
see DESIGN.md §4.  Units: FLOPs and bytes, matching
``repro_torch.core.platform.h100_fleet_si`` (speed = FLOP/s, memory =
bytes, β = bytes/s).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

from .dag import Workflow

__all__ = ["build_model_graph", "TaskInfo"]

BYTES = 2          # bf16 activations/weights
OPT_FACTOR = 9     # train: weights + grads + f32 (master, m, v) ≈ 18B/param


@dataclass(frozen=True)
class TaskInfo:
    kind: str              # embed | attn | mamba | rwkv | ffn | expert |
                           # router | cross | encoder | head | frontend
    layer: int             # -1 for non-layer tasks
    expert: int            # -1 unless kind == expert


def _train_factor(shape: ShapeConfig) -> float:
    """fwd+bwd ≈ 3× forward FLOPs for training shapes."""
    return 3.0 if shape.kind == "train" else 1.0


def _attn_flops(cfg: ModelConfig, tokens: int, kv_len: int) -> float:
    d, hd = cfg.d_model, cfg.hd
    proj = 2.0 * tokens * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    proj += 2.0 * tokens * cfg.n_heads * hd * d
    win = kv_len if cfg.sliding_window <= 0 else min(kv_len,
                                                     cfg.sliding_window)
    scores = 2.0 * 2.0 * tokens * win * cfg.n_heads * hd
    return proj + scores


def _mamba_flops(cfg: ModelConfig, tokens: int) -> float:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    r = max(1, d // 16)
    n = cfg.mamba_d_state
    return tokens * (
        2.0 * d * 2 * di + di * cfg.mamba_d_conv + 2.0 * di * (r + 2 * n)
        + 2.0 * r * di + 8.0 * di * n + 2.0 * di * d)


def _rwkv_flops(cfg: ModelConfig, tokens: int) -> float:
    d = cfg.d_model
    dh = cfg.n_heads * cfg.hd
    return tokens * (5 * 2.0 * d * dh + 2.0 * dh * d + 6.0 * dh * cfg.hd)


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    return 2.0 * 3.0 * tokens * cfg.d_model * cfg.d_ff


def build_model_graph(cfg: ModelConfig, shape: ShapeConfig,
                      *, microbatches: int = 1) -> tuple[Workflow, dict]:
    """Returns (workflow, info) where ``info[task_id] -> TaskInfo``.

    ``microbatches`` scales the activation working set for pipelined
    training (the scheduler sees per-microbatch memory).
    """
    b, s = shape.global_batch, shape.seq_len
    decode = shape.is_decode
    tokens = b * (1 if decode else s)
    tf = _train_factor(shape)
    act_bytes = (b * (1 if decode else s) * cfg.d_model * BYTES
                 / max(microbatches, 1))
    wfac = OPT_FACTOR if shape.kind == "train" else 1
    kv_len = s

    wf = Workflow(name=f"{cfg.name}:{shape.name}")
    info: dict[int, TaskInfo] = {}

    def task(kind, layer, flops, param_count, extra_mem=0.0, expert=-1,
             label=None):
        t = wf.add_task(
            work=flops * tf,
            mem=2.0 * act_bytes,  # transient working set while the op runs
            label=label or f"{kind}{layer if layer >= 0 else ''}",
            # weights (+ optimizer state when training) and KV/state
            # caches stay resident on the block's processor
            persistent=param_count * BYTES * wfac + extra_mem,
        )
        info[t] = TaskInfo(kind, layer, expert)
        return t

    # --- embedding ----------------------------------------------------- #
    embed = task("embed", -1, tokens * cfg.d_model,
                 cfg.vocab_size * cfg.d_model)
    prev = embed

    # --- frontend / encoder -------------------------------------------- #
    memory_src = None
    if cfg.frontend_tokens:
        fr_tokens = b * cfg.frontend_tokens
        fr_bytes = fr_tokens * cfg.d_model * BYTES
        frontend = task("frontend", -1, fr_tokens * cfg.d_model,
                        cfg.frontend_dim * cfg.d_model, label="frontend")
        memory_src = frontend
        if cfg.is_encdec:
            for i in range(cfg.n_encoder_layers):
                fl = (_attn_flops(cfg, fr_tokens, cfg.frontend_tokens)
                      + _ffn_flops(cfg, fr_tokens))
                t = task("encoder", i, fl,
                         cfg.attn_params() + cfg.mlp_params(),
                         label=f"enc{i}")
                wf.add_edge(memory_src, t, fr_bytes)
                memory_src = t

    # --- decoder layers -------------------------------------------------#
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            kv_cache = (b * kv_len * 2 * cfg.n_kv_heads * cfg.hd * BYTES
                        if decode else 0.0)
            fl = _attn_flops(cfg, tokens, kv_len if decode else s)
            if decode and kv_cache > 0:
                # Decode: the KV cache dominates a layer's residency; a
                # whole layer would be an atomic 10s-of-GB task no chip
                # can hold.  Split by KV head groups — the partitioner
                # then performs head-level tensor parallelism (the
                # placement analogue of sharding the cache over the
                # "model" axis in repro_torch.launch.sharding).
                groups = max(1, cfg.n_kv_heads // 2)
                fan = task("attn_split", i, tokens * cfg.d_model, 0,
                           label=f"attnsplit{i}")
                wf.add_edge(prev, fan, act_bytes)
                join = task("attn_join", i, tokens * cfg.d_model, 0,
                            label=f"attnjoin{i}")
                for gidx in range(groups):
                    gt = task("attn", i, fl / groups,
                              cfg.attn_params() // groups,
                              extra_mem=kv_cache / groups,
                              label=f"attn{i}h{gidx}")
                    wf.add_edge(fan, gt, act_bytes / groups)
                    wf.add_edge(gt, join, act_bytes / groups)
                mix = join
                prev = fan  # keep residual edge bookkeeping simple
            else:
                mix = task("attn", i, fl, cfg.attn_params(),
                           extra_mem=kv_cache)
        elif kind == "mamba":
            state = (b * cfg.mamba_expand * cfg.d_model
                     * cfg.mamba_d_state * 4 if decode else 0.0)
            mix = task("mamba", i, _mamba_flops(cfg, tokens),
                       cfg.mamba_params(), extra_mem=state)
        else:
            state = (b * cfg.n_heads * cfg.hd * cfg.hd * 4
                     if decode else 0.0)
            mix = task("rwkv", i, _rwkv_flops(cfg, tokens),
                       cfg.rwkv_params(), extra_mem=state)
        wf.add_edge(prev, mix, act_bytes)

        if cfg.layer_cross_attends(i) and memory_src is not None:
            cross = task("cross", i, _attn_flops(cfg, tokens,
                                                 cfg.frontend_tokens),
                         cfg.attn_params(), label=f"cross{i}")
            wf.add_edge(mix, cross, act_bytes)
            wf.add_edge(memory_src, cross,
                        b * cfg.frontend_tokens * cfg.d_model * BYTES)
            mix = cross

        if cfg.layer_is_moe(i):
            router = task("router", i, 2.0 * tokens * cfg.d_model
                          * cfg.n_experts,
                          cfg.d_model * cfg.n_experts, label=f"router{i}")
            wf.add_edge(mix, router, act_bytes)
            join = task("combine", i, tokens * cfg.d_model,
                        0, label=f"combine{i}")
            routed = act_bytes * cfg.experts_per_token / cfg.n_experts
            per_exp_tokens = (tokens * cfg.experts_per_token
                              / cfg.n_experts)
            for e in range(cfg.n_experts):
                ex = task("expert", i, _ffn_flops(cfg, per_exp_tokens),
                          cfg.mlp_params(), expert=e,
                          label=f"L{i}e{e}")
                wf.add_edge(router, ex, routed)
                wf.add_edge(ex, join, routed)
            prev = join
        else:
            ffn = task("ffn", i, _ffn_flops(cfg, tokens),
                       cfg.mlp_params())
            wf.add_edge(mix, ffn, act_bytes)
            prev = ffn

    # --- head ------------------------------------------------------------#
    head_params = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    head = task("head", -1, 2.0 * tokens * cfg.d_model * cfg.vocab_size,
                head_params)
    wf.add_edge(prev, head, act_bytes)
    return wf, info
