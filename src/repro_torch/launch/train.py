"""Training launcher — port of ``repro/launch/train.py``.

Two modes:

* smoke (the default): trains the selected arch's reduced config through
  the fault-tolerant :class:`Trainer`, on the card unless ``--device
  cpu``.  As in the JAX launcher, nothing supervises the run: with
  ``--inject-fault-at`` the injected
  :class:`~repro_torch.runtime.SimulatedFault` ends the command, and a
  rerun on the same ``--ckpt-dir`` resumes from the latest checkpoint
  (:func:`~repro_torch.runtime.run_with_restarts` is the supervisor for
  callers that want the restart in-process);
* ``--production [--shape train_4k]``: the full-size train step's dry run
  on the production mesh (:func:`repro_torch.launch.dryrun.run_cell`: the
  step on meta tensors over a fake group of 256 ranks, analysed per rank;
  no card is needed), its cell written under ``experiments/dryrun_torch/``;
  exits 0 exactly when the cell's status is ``"ok"``.

Examples::

    python -m repro_torch.launch.train --arch llama3_8b --device cpu
    python -m repro_torch.launch.train --arch mixtral_8x7b --production --shape train_4k
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

__all__ = ["main"]

_log = logging.getLogger(__name__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not logging.getLogger().handlers:     # CLI: bare messages on stdout
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stdout)

    if args.production:
        from repro_torch.launch.dryrun import run_production
        return run_production(args.arch, args.shape)

    cfg = get_smoke_config(args.arch)
    shape = ShapeConfig("smoke_train", args.seq_len, args.batch, "train")
    injector = None
    if args.inject_fault_at is not None:
        injector = FailureInjector(fail_at_steps=(args.inject_fault_at,))
    trainer = Trainer(cfg, shape,
                      TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir),
                      attn_chunk=16, injector=injector, device=args.device)
    hist = trainer.run()
    _log.info("steps: %d  first loss: %.4f  last loss: %.4f  on %s",
              len(hist["loss"]), hist["loss"][0], hist["loss"][-1], args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
