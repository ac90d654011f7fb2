"""Training entry points on SemanticKITTI, `train-kitti`, and on
BundleFusion, `train-bundlefusion`: the counterparts of
`scenerf_tpu/cli/train.py:28-312` on one device.

    python -m scenerf_tpu_torch.cli.train train-kitti --root KITTI \\
        --preprocess_root PRE --logdir LOGS [--device cpu] [...]
    python -m scenerf_tpu_torch.cli.train train-bundlefusion --root BF \\
        --logdir LOGS [--device cpu] [...]

Same flags, defaults and experiment names as the JAX package's commands,
plus `--device` (cuda:0 unless given cpu), `--seed`, and for
train-bundlefusion `--sequences` / `--val_sequences`. Each epoch reads a
shuffled half (KITTI) or all (BundleFusion) of the train set
(`len(train_loader)` steps: the staircase lr's epoch), then validates on
the val split (sequence 08; copyroom) and saves `last` (and `best`, on the
mean val `depth/abs_rel`) under `{logdir}/ckpts/{exp_name}`; metrics go to
`{logdir}/tb/{exp_name}/metrics.jsonl`. A run whose checkpoint directory
holds `last` resumes from it at the start of the epoch its step is in.

Multi-GPU training: one process per card, started by torchrun, with
`--parallel_mode` (JAX's modes; `--bs` is the global batch):

    torchrun --nproc_per_node 4 -m scenerf_tpu_torch.cli.train train-kitti \
        --parallel_mode data --bs 4 ...          # or ray_parallel, ray_shard

Rank r takes cuda:{LOCAL_RANK} (unless `--device` names one card for all);
`--dist_backend` is nccl on CUDA and gloo on the CPU by default. In data mode
the world must divide `--bs`. Rank 0 writes the checkpoints, the metrics and
the printed lines; every rank resumes from the same `last`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import click
import numpy as np
import torch

from scenerf_tpu_torch import config as CFG
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.data.loader import DataLoader
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.parallel import dist as D
from scenerf_tpu_torch.train import MODES, Trainer
from scenerf_tpu_torch.utils.checkpoint import CheckpointManager
from scenerf_tpu_torch.utils.logging_utils import MetricLogger

LOG_EVERY = 10  # steps between host reads of the training metrics


def run_training(cfg: CFG.SceneRFConfig, train_ds, val_ds,
                 collate: Callable[[List[Dict]], Dict[str, np.ndarray]], exp_name: str,
                 logdir: str, n_epochs: int, enable_log: bool,
                 limit_train_fraction: float = 0.5, batch_size: int = 1, seed: int = 42,
                 max_steps_per_epoch: Optional[int] = None, device="cuda:0", group=None,
                 parallel_mode: str = "data") -> Dict:
    """The epoch loop. The model's weights come from `torch.manual_seed(seed)`
    on the host, the training draws from the trainer's host generator seeded
    with `seed`, val batch i's draws from a generator seeded by (seed, 0x5EED,
    i), the same in every epoch and across a resume; the train
    loader shuffles with `seed`. A resumed run skips the shuffles of the
    epochs it has done, so its epochs read the batches an uninterrupted run
    reads (the datasets' own draws restart from their seeds).

    `group` (a process group; None: one rank) and `parallel_mode` (one of
    train.MODES): in data mode each rank reads its slice of every global
    batch of `batch_size` items (train and val), in the ray modes every rank
    reads the whole batch; each rank's draws are the trainer's
    (`Trainer.draw_seed`); the val metrics are the ranks' mean; rank 0 alone
    writes checkpoints and metrics, and the ranks meet at a barrier after
    each save.

    Returns the trainer, the step it started from, and the host clock's
    record: "loss" (per step, read once an epoch), "step_s" (per step, the
    time between consecutive step ends; the epoch's last ends at a
    synchronize), "val_s", "val_items" and "val_metrics" per epoch, "save_s"
    per save, and the loaders' timings of their last epoch."""
    device = torch.device(device)
    rank, world = D.rank(group), D.size(group)
    lead = rank == 0
    sliced = dict(process_index=rank, process_count=world) if parallel_mode == "data" else {}
    train_loader = DataLoader(train_ds, collate, batch_size=batch_size, shuffle=True,
                              limit_fraction=limit_train_fraction, seed=seed,
                              max_batches=max_steps_per_epoch, **sliced)
    val_loader = DataLoader(val_ds, collate, batch_size=batch_size, shuffle=False,
                            max_batches=max_steps_per_epoch, **sliced)
    steps_per_epoch = max(1, len(train_loader))

    torch.manual_seed(seed)
    trainer = Trainer(cfg, device=device, steps_per_epoch=steps_per_epoch, model=SceneRF(cfg),
                      seed=seed, group=group, mode=parallel_mode)
    mgr = CheckpointManager(os.path.join(logdir, "ckpts", exp_name), monitor="depth/abs_rel",
                            mode="min")
    logger = MetricLogger(os.path.join(logdir, "tb", exp_name) if enable_log and lead else None)
    if mgr.latest() is not None:
        trainer.load_state_dict(mgr.restore("last"))
        if lead:
            print(f"resumed from step {trainer.step} (epoch {trainer.step // steps_per_epoch})")
    start_step = trainer.step
    start_epoch = trainer.step // steps_per_epoch
    for _ in range(start_epoch):
        train_loader.epoch_order()  # the shuffles of the epochs done

    record = {k: [] for k in ("loss", "step_s", "val_s", "val_items", "val_metrics", "save_s")}
    for epoch in range(start_epoch, n_epochs):
        t_epoch = t_prev = time.perf_counter()
        losses = []
        for batch in train_loader:
            metrics = trainer.train_step(batch)
            losses.append(metrics["total_loss"])
            if trainer.step % LOG_EVERY == 0 and lead:
                host = {k: float(v) for k, v in metrics.items()}
                logger.log(host, trainer.step, "train")
                logger.log_lr(trainer.lr_at(trainer.step), trainer.step)
                print(f"epoch {epoch} step {trainer.step} loss {host['total_loss']:.4f}")
            t = time.perf_counter()
            record["step_s"].append(t - t_prev)
            t_prev = t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if losses:
            record["step_s"][-1] += time.perf_counter() - t_prev
            record["loss"] += torch.stack(losses).tolist()

        t0 = time.perf_counter()
        sums, n_val = None, 0
        for bi, batch in enumerate(val_loader):
            val_seed = int(np.random.SeedSequence([seed, 0x5EED, bi]).generate_state(1)[0])
            m = trainer.val_step(batch, torch.Generator().manual_seed(trainer.draw_seed(val_seed)))
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            n_val += 1
        val_metrics = {k: float(v) / n_val for k, v in sums.items()} if sums else None
        record["val_s"].append(time.perf_counter() - t0)
        record["val_items"].append(n_val * batch_size)
        record["val_metrics"].append(val_metrics)

        t0 = time.perf_counter()
        state = trainer.state_dict()  # a collective over several ranks
        if lead:
            mgr.save(state, cfg, metrics=val_metrics)
        D.barrier(group)
        record["save_s"].append(time.perf_counter() - t0)
        if val_metrics and lead:
            logger.log(val_metrics, trainer.step, "val")
            print(f"epoch {epoch} ({time.perf_counter() - t_epoch:.0f}s) "
                  f"val abs_rel {val_metrics.get('depth/abs_rel', float('nan')):.4f}")
    logger.close()
    return {"trainer": trainer, "start_step": start_step, "checkpoints": mgr,
            "train_timings": train_loader.timings, "val_timings": val_loader.timings,
            **record}


PARALLEL_OPT = click.option(
    "--parallel_mode", default="data", type=click.Choice(MODES),
    help="under torchrun: data (items split over the ranks), ray_parallel (every rank the "
         "same items, its own rays), ray_shard (every rank 1/W of each item's rays)")


def check_world(world: D.World, parallel_mode: str, bs: int) -> None:
    """Data mode needs a world that divides the global batch (JAX meshes over
    the largest device count that does; torchrun's world is fixed)."""
    if parallel_mode == "data":
        try:
            D.local_batch_size(bs, world.size)
        except ValueError:
            raise click.UsageError(f"--parallel_mode data: the {world.size} ranks do not "
                                   f"divide --bs {bs} (start as many ranks as divide it, or "
                                   f"take a ray mode)") from None


@click.group()
def cli():
    """Training on SemanticKITTI and BundleFusion."""


@cli.command("train-kitti")
@click.option("--root", default="", help="path to dataset folder")
@click.option("--preprocess_root", default="", help="path to preprocess folder")
@click.option("--logdir", default="", help="log/checkpoint directory")
@click.option("--bs", default=1, help="batch size")
@click.option("--n_rays", default=1200)
@click.option("--n_sources", default=1, help="sources per step (fixed shape)")
@click.option("--lr", default=1e-5)
@click.option("--weight_decay", default=0.0)
@click.option("--n_epochs", default=50)
@click.option("--enable_log", default=True, type=bool)
@click.option("--sequence_distance", default=10.0)
@click.option("--frames_interval", default=0.4)
@click.option("--n_gaussians", default=4)
@click.option("--n_pts_per_gaussian", default=8)
@click.option("--n_pts_uni", default=32)
@click.option("--n_gt_depth", default=1024)
@click.option("--std", default=2.0)
@click.option("--add_fov_hor", default=20.0)
@click.option("--add_fov_ver", default=8.0)
@click.option("--sphere_w", default=1500)
@click.option("--sphere_h", default=452)
@click.option("--som_sigma", default=2.0)
@click.option("--max_sample_depth", default=100.0)
@click.option("--eval_depth", default=80.0, help="cap depth for evaluation")
@click.option("--use_color", default=True, type=bool)
@click.option("--use_reprojection", default=True, type=bool)
@click.option("--encoder", default="effnet-b7")
@click.option("--exp_prefix", default="exp")
@click.option("--compute_dtype", default="float32")
@click.option("--max_steps_per_epoch", default=None, type=int)
@click.option("--sequences", default="", help="comma list overriding the train split")
@click.option("--val_sequences", default="", help="comma list overriding the val split")
@click.option("--seed", default=42, help="weights, draws and shuffles")
@PARALLEL_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def train_kitti(root, preprocess_root, logdir, bs, n_rays, n_sources, lr, weight_decay,
                n_epochs, enable_log, sequence_distance, frames_interval, n_gaussians,
                n_pts_per_gaussian, n_pts_uni, n_gt_depth, std, add_fov_hor, add_fov_ver,
                sphere_w, sphere_h, som_sigma, max_sample_depth, eval_depth, use_color,
                use_reprojection, encoder, exp_prefix, compute_dtype, max_steps_per_epoch,
                sequences, val_sequences, seed, parallel_mode, device, dist_backend):
    """Train SceneRF on SemanticKITTI."""
    from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch

    world = common.join_world(device, dist_backend)
    device = world.device
    check_world(world, parallel_mode, bs)
    cfg = CFG.kitti(
        n_rays=n_rays, n_sources=n_sources, lr=lr, weight_decay=weight_decay,
        n_gaussians=n_gaussians, n_pts_per_gaussian=n_pts_per_gaussian, n_pts_uni=n_pts_uni,
        std=std, som_sigma=som_sigma, max_sample_depth=max_sample_depth, eval_depth=eval_depth,
        use_color=use_color, use_reprojection=use_reprojection, encoder=encoder,
        n_gt_depth=n_gt_depth, compute_dtype=compute_dtype,
        sphere=CFG.SphereConfig(width=sphere_w, height=sphere_h, add_fov_hor=add_fov_hor,
                                add_fov_ver=add_fov_ver))
    exp_name = (f"{exp_prefix}_kitti_rays{n_rays}_gauss{n_gaussians}x{n_pts_per_gaussian}"
                f"_std{std}_sigma{som_sigma}_fov{add_fov_hor}x{add_fov_ver}"
                f"_sphere{sphere_w}x{sphere_h}")
    print("exp_name:", exp_name)
    ds_kw = dict(frames_interval=frames_interval, sequence_distance=sequence_distance,
                 n_sources=n_sources, n_rays=n_gt_depth, seed=42)
    train_ds = KittiDataset("train", root, preprocess_root,
                            sequences=sequences.split(",") if sequences else None, **ds_kw)
    val_ds = KittiDataset("val", root, preprocess_root,
                          sequences=val_sequences.split(",") if val_sequences else None, **ds_kw)
    return run_training(cfg, train_ds, val_ds, lambda items: to_model_batch(items, cfg),
                        exp_name, logdir, n_epochs, enable_log, limit_train_fraction=0.5,
                        batch_size=bs, seed=seed, max_steps_per_epoch=max_steps_per_epoch,
                        device=device, group=world.group, parallel_mode=parallel_mode)


@cli.command("train-bundlefusion")
@click.option("--root", default="", help="path to bundlefusion folder")
@click.option("--logdir", default="")
@click.option("--bs", default=1)
@click.option("--n_rays", default=2048)
@click.option("--n_sources", default=1)
@click.option("--lr", default=2e-5)
@click.option("--weight_decay", default=0.0)
@click.option("--n_epochs", default=50)
@click.option("--enable_log", default=True, type=bool)
@click.option("--frame_interval", default=2)
@click.option("--n_frames", default=16)
@click.option("--n_gaussians", default=4)
@click.option("--n_pts_per_gaussian", default=8)
@click.option("--n_pts_uni", default=32)
@click.option("--n_gt_depth", default=1024)
@click.option("--std", default=0.2)
@click.option("--som_sigma", default=0.02)
@click.option("--sample_grid_size", default=2)
@click.option("--sampling_method", default="uniform", type=click.Choice(["uniform", "log"]))
@click.option("--max_sample_depth", default=12.0)
@click.option("--eval_depth", default=10.0, help="cap depth for evaluation")
@click.option("--add_fov_hor", default=14.0)
@click.option("--add_fov_ver", default=11.0)
@click.option("--sphere_w", default=960)
@click.option("--sphere_h", default=720)
@click.option("--use_color", default=True, type=bool)
@click.option("--use_reprojection", default=True, type=bool)
@click.option("--img_w", default=640, help="input width (smoke runs shrink it)")
@click.option("--img_h", default=480, help="input height (smoke runs shrink it)")
@click.option("--encoder", default="effnet-b7")
@click.option("--encoder_features", default=2560, help="bottleneck channels (matches --encoder)")
@click.option("--exp_prefix", default="exp")
@click.option("--compute_dtype", default="float32")
@click.option("--max_steps_per_epoch", default=None, type=int)
@click.option("--sequences", default="", help="comma list overriding the train scenes")
@click.option("--val_sequences", default="", help="comma list overriding the val scenes")
@click.option("--seed", default=42, help="weights, draws and shuffles")
@PARALLEL_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def train_bundlefusion(root, logdir, bs, n_rays, n_sources, lr, weight_decay, n_epochs,
                       enable_log, frame_interval, n_frames, n_gaussians, n_pts_per_gaussian,
                       n_pts_uni, n_gt_depth, std, som_sigma, sample_grid_size, sampling_method,
                       max_sample_depth, eval_depth, add_fov_hor, add_fov_ver, sphere_w,
                       sphere_h, use_color, use_reprojection, img_w, img_h, encoder,
                       encoder_features, exp_prefix, compute_dtype, max_steps_per_epoch,
                       sequences, val_sequences, seed, parallel_mode, device, dist_backend):
    """Train SceneRF on BundleFusion."""
    from scenerf_tpu_torch.data.bundlefusion import BundlefusionDataset, to_model_batch

    world = common.join_world(device, dist_backend)
    device = world.device
    check_world(world, parallel_mode, bs)
    cfg = CFG.bundlefusion(
        n_rays=n_rays, n_sources=n_sources, lr=lr, weight_decay=weight_decay,
        n_gaussians=n_gaussians, n_pts_per_gaussian=n_pts_per_gaussian, n_pts_uni=n_pts_uni,
        std=std, som_sigma=som_sigma, encoder=encoder, n_gt_depth=n_gt_depth,
        sample_grid_size=sample_grid_size, sampling_method=sampling_method,
        max_sample_depth=max_sample_depth, eval_depth=eval_depth, use_color=use_color,
        use_reprojection=use_reprojection, img_size=(img_w, img_h),
        encoder_features=encoder_features, compute_dtype=compute_dtype)
    # the BundleFusion-calibrated base angles stay: only the grid and the
    # FOV margins are flags
    cfg = cfg.replace(sphere=dataclasses.replace(cfg.sphere, width=sphere_w, height=sphere_h,
                                                 add_fov_hor=add_fov_hor,
                                                 add_fov_ver=add_fov_ver))
    exp_name = (f"{exp_prefix}_bf_rays{n_rays}_gauss{n_gaussians}x{n_pts_per_gaussian}"
                f"_std{std}_sigma{som_sigma}")
    print("exp_name:", exp_name)
    ds_kw = dict(n_sources=n_sources, frame_interval=frame_interval, n_frames=n_frames, seed=42)
    train_ds = BundlefusionDataset("train", root,
                                   sequences=sequences.split(",") if sequences else None, **ds_kw)
    val_ds = BundlefusionDataset("val", root,
                                 sequences=val_sequences.split(",") if val_sequences else None,
                                 **ds_kw)
    return run_training(cfg, train_ds, val_ds, lambda items: to_model_batch(items, cfg),
                        exp_name, logdir, n_epochs, enable_log, limit_train_fraction=1.0,
                        batch_size=bs, seed=seed, max_steps_per_epoch=max_steps_per_epoch,
                        device=device, group=world.group, parallel_mode=parallel_mode)


if __name__ == "__main__":
    cli()
