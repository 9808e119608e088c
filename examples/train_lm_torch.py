"""End-to-end training on the PyTorch port: train a small LM with the
port's whole stack — data pipeline, AdamW, async checkpointing,
restart-on-failure (``repro_torch.runtime``) — on an NVIDIA card by
default, through the Hopper flash kernels; ``--device cpu`` runs it on the
CPU (the kernels' plain versions).  The counterpart of
``examples/train_lm.py``, with its presets and flags.

Presets:
  tiny (default, seconds):  2-layer, ~0.3M params, 60 steps
  20m:                      8-layer d=384, ~20M params, 100 steps
  100m:                     12-layer d=768 GQA, ~103M params, 300 steps

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--preset tiny] [--device cpu]
"""
import argparse
import os
import tempfile
import time

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig, run_with_restarts

PRESETS = {
    "tiny": dict(
        cfg=ModelConfig("tiny-lm", "dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=512),
        shape=ShapeConfig("tiny", seq_len=32, global_batch=8,
                          kind="train"),
        steps=60,
    ),
    "20m": dict(
        cfg=ModelConfig("lm-20m", "dense", n_layers=8, d_model=384,
                        n_heads=6, n_kv_heads=2, d_ff=1024,
                        vocab_size=8192),
        shape=ShapeConfig("s20m", seq_len=128, global_batch=8,
                          kind="train"),
        steps=100,
    ),
    "100m": dict(
        cfg=ModelConfig("lm-100m", "dense", n_layers=12, d_model=768,
                        n_heads=12, n_kv_heads=4, d_ff=2048,
                        vocab_size=32768),
        shape=ShapeConfig("s100m", seq_len=256, global_batch=16,
                          kind="train"),
        steps=300,
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    preset = PRESETS[args.preset]
    cfg, shape = preset["cfg"], preset["shape"]
    steps = args.steps or preset["steps"]
    print(f"model: {cfg.name} ({cfg.total_params() / 1e6:.1f}M params), "
          f"{steps} steps of {shape.global_batch}x{shape.seq_len} tokens on {args.device}")

    injector = None
    if args.inject_fault_at is not None:
        injector = FailureInjector(fail_at_steps=(args.inject_fault_at,))

    def make_trainer():
        return Trainer(
            cfg, shape,
            TrainerConfig(steps=steps, ckpt_every=max(steps // 6, 5),
                          ckpt_dir=args.ckpt_dir),
            attn_chunk=64,
            injector=injector,
            device=args.device,
        )

    t0 = time.perf_counter()
    hist, restarts = run_with_restarts(make_trainer, lambda t: t.run())
    dt = time.perf_counter() - t0
    tok_s = len(hist["loss"]) * shape.global_batch * shape.seq_len / dt
    print(f"loss: {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
          f"({dt:.1f}s, {tok_s:.0f} tok/s, {restarts} restarts)")
    assert hist["loss"][-1] < hist["loss"][0], "training did not improve"


if __name__ == "__main__":
    main()
