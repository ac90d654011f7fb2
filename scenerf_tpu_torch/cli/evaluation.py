"""Evaluation entry points on the KITTI val split. So far `eval-sr`: scene
reconstruction occupancy IoU / precision / recall of the fused TSDFs against
the SemanticKITTI voxel GT, printed as `scenerf_tpu/cli/evaluation.py:438
eval_sr` prints them. Host numpy only: it needs no device.

    python -m scenerf_tpu_torch.cli.evaluation eval-sr --root ... --recon_save_dir out
"""
from __future__ import annotations

import os

import click
import numpy as np

from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics


@click.group()
def cli():
    """KITTI evaluation."""


@cli.command("eval-sr")
@common.add_opts(common.KITTI_OPTS)
@click.option("--recon_save_dir", default="")
def eval_sr(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
            frames_interval, recon_save_dir):
    """Scene-reconstruction occupancy IoU/P/R against the voxel GT."""
    ds = common.kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval,
                             load_voxels=True)
    metric, fov_metric = SSCMetrics(2), SSCMetrics(2)
    for idx in range(len(ds)):
        item = ds[idx]
        tsdf_path = os.path.join(recon_save_dir, "tsdf", item["sequence"],
                                 item["frame_id"] + ".npy")
        if not os.path.exists(tsdf_path):
            continue
        recon.eval_sr_frame(np.load(tsdf_path), item["target_1_1"], item["fov_mask_1"],
                            metric, fov_metric)

    print("==== Whole Scene ====")
    s = metric.get_stats()
    print(s["iou"], s["precision"], s["recall"])
    print("==== in FOV ====")
    s = fov_metric.get_stats()
    print(s["iou"], s["precision"], s["recall"])
    return metric.get_stats(), fov_metric.get_stats()


if __name__ == "__main__":
    cli()
