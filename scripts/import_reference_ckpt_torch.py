#!/usr/bin/env python
"""Import a published SceneRF checkpoint into the PyTorch port: the
counterpart of scripts/import_reference_ckpt.py.

The reference publishes Lightning checkpoints (scenerf_kitti.ckpt,
scenerf_bundlefusion.ckpt) with the model weights under `state_dict` and the
training flags under `hyper_parameters`. This writes a port checkpoint
directory (`last` and `best`, a fresh trainer state) that `load_model` and
every CLI of `scenerf_tpu_torch` take through --model_path
(`scenerf_tpu_torch/utils/port_reference.py`). Runs on the CPU; imports no
JAX.

    python scripts/import_reference_ckpt_torch.py \\
        --ckpt scenerf_kitti.ckpt --preset kitti --out ckpts/scenerf_kitti
    python -m scenerf_tpu_torch.cli.evaluation save-depth-metrics \\
        --model_path ckpts/scenerf_kitti ...
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="reference .ckpt path")
    ap.add_argument("--preset", default="kitti", choices=["kitti", "bundlefusion", "tiny"],
                    help="the config preset the hparams apply to (tiny: the tests' small one)")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    args = ap.parse_args(argv)

    from scenerf_tpu_torch.utils.port_reference import import_reference_checkpoint

    _, model = import_reference_checkpoint(args.ckpt, args.preset, args.out)
    n_params = sum(1 for _ in model.parameters())
    print(f"imported {args.ckpt} -> {args.out} (preset {args.preset}, {n_params} param "
          f"tensors, {len(model.state_dict())} with the BN statistics)")


if __name__ == "__main__":
    main()
