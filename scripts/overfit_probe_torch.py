#!/usr/bin/env python
"""Overfit-one-frame convergence probe of the PyTorch port: the counterpart
of scripts/overfit_probe.py.

Trains `config.tiny(lr, n_rays, ray_chunk=n_rays)` on one geometrically
consistent synthetic frame (`data/synthetic.make_geometric_batch`: a
textured slanted plane with its analytic depth) and prints the loss, the
reprojection loss and the depth abs_rel of the training step every
--eval_every steps, then the best abs_rel. The loss stack should drive
abs_rel well below what a frame whose views disagree allows. Runs on cuda:0
unless --device cpu.

    python scripts/overfit_probe_torch.py --steps 300 --lr 1e-3 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval_every", type=int, default=25)
    ap.add_argument("--n_rays", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import make_geometric_batch
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    cfg = C.tiny(lr=args.lr, n_rays=args.n_rays, ray_chunk=args.n_rays)
    torch.manual_seed(args.seed)
    trainer = Trainer(cfg, device=args.device, steps_per_epoch=args.steps, model=SceneRF(cfg),
                      seed=args.seed + 1)
    batch = make_geometric_batch(cfg, seed=args.seed)

    t0 = time.time()
    best = float("inf")
    for step in range(args.steps):
        m = trainer.train_step(batch)
        if (step + 1) % args.eval_every == 0 or step == 0:
            abs_rel = float(m["depth/abs_rel"])
            best = min(best, abs_rel)
            print(f"step {step + 1:4d}  loss={float(m['total_loss']):.4f}  "
                  f"reproj={float(m['loss_reprojection']):.4f}  "
                  f"abs_rel={abs_rel:.4f}  ({time.time() - t0:.0f}s)", flush=True)
    print(f"BEST abs_rel={best:.4f}")
    return best


if __name__ == "__main__":
    main()
