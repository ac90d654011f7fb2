"""Import a published SceneRF Lightning checkpoint into the port. The
counterpart of `scenerf_tpu/utils/port_reference.py:120-196`.

The reference publishes `scenerf_kitti.ckpt` and `scenerf_bundlefusion.ckpt`:
`torch.save` dicts with the model's weights under `state_dict` and the click
flags of its training command under `hyper_parameters` (Lightning's
`save_hyperparameters`). The port's parameter names are the reference's
(timm's EfficientNet layout under `net_rgb.encoder.original_model`, the
decoder under `net_rgb.decoder`, the two ResnetFC heads under `mlp` and
`mlp_gaussian`), so the weights load as they are, minus the keys the
reference forward never reads (`utils/weights.reference_model_state`).

    cfg, model = import_reference_checkpoint("scenerf_kitti.ckpt", "kitti", "ckpts/kitti")
    load_model("ckpts/kitti", "cuda:0")      # and every CLI's --model_path

The output is a `utils/checkpoint.CheckpointManager` directory holding
`last` and `best` with a fresh trainer state (step 0, no AdamW moments), so
`train-kitti` can also resume from it: its best value is +inf, so the first
validation of a resumed run writes a new `best`.

`save_reference_layout` writes the other way, a port state_dict in the
published checkpoints' on-disk layout, for tests and `chip_smoke.py`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Tuple

import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import weights as W
from scenerf_tpu_torch.utils.checkpoint import CheckpointManager

# Lightning `save_hyperparameters` keys (the reference's SceneRF.__init__
# arguments) that map 1:1 onto SceneRFConfig fields of the same name
_HPARAM_KEYS = (
    "n_rays", "n_gaussians", "n_pts_per_gaussian", "n_pts_uni", "std",
    "som_sigma", "lr", "weight_decay", "max_sample_depth", "max_infer_depth",
    "eval_depth", "sampling_method", "use_color", "use_reprojection",
    "batch_size",
)
# what a published B7 checkpoint carries beside the model and the reference
# forward never reads (weights._skipped), at B7's shapes; the decoder's
# resize convs are stand-ins of their names
_UNREAD = {**{f"{W.ENCODER}.bn2.{k}": (2560,)
              for k in ("weight", "bias", "running_mean", "running_var")},
           f"{W.ENCODER}.classifier.weight": (1000, 2560),
           f"{W.ENCODER}.classifier.bias": (1000,),
           **{f"{W.DECODER}.resize_output_1_{s}.{k}": shape
              for s in (1, 2, 4, 8, 16)
              for k, shape in (("weight", (16, 16, 1, 1)), ("bias", (16,)))}}


def config_from_hparams(preset: str, hp: Mapping[str, Any], **base) -> C.SceneRFConfig:
    """A config from a Lightning checkpoint's `hyper_parameters` (the
    reference's flag names) on the preset `preset` of `config.PRESETS`.
    `base` holds config fields that no real checkpoint carries (the
    reference always builds B7); tests use them to shrink the model.

    `sphere_W` / `sphere_H` (with `add_fov_hor` / `add_fov_ver`) replace the
    preset sphere's grid and margins and keep its base angles, as
    `train-bundlefusion` does. The JAX function rebuilds the sphere from
    KITTI's default angles, which turns a BundleFusion checkpoint's sphere
    into KITTI's."""
    overrides = dict(base)
    overrides.update({k: hp[k] for k in _HPARAM_KEYS if k in hp})
    if "img_size" in hp:
        overrides["img_size"] = tuple(hp["img_size"])
    cfg = C.PRESETS[preset](**overrides)
    if "sphere_W" in hp and "sphere_H" in hp:
        cfg = cfg.replace(sphere=dataclasses.replace(
            cfg.sphere, width=int(hp["sphere_W"]), height=int(hp["sphere_H"]),
            add_fov_hor=float(hp.get("add_fov_hor", cfg.sphere.add_fov_hor)),
            add_fov_ver=float(hp.get("add_fov_ver", cfg.sphere.add_fov_ver))))
    return cfg


def validate_against_model(model_state: Mapping[str, torch.Tensor],
                           ported: Mapping[str, Any]) -> None:
    """Raise ValueError unless `ported` has exactly the keys of the model's
    state_dict and each its shape; the error names the first keys or the
    first shape that differ."""
    missing = sorted(set(model_state) - set(ported))
    extra = sorted(set(ported) - set(model_state))
    if missing or extra:
        raise ValueError(f"tree mismatch: missing={missing[:5]} extra={extra[:5]}")
    for k, v in model_state.items():
        if tuple(ported[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: {tuple(ported[k].shape)} != {tuple(v.shape)}")


def import_reference_checkpoint(ckpt_path: str, preset: str, out: str,
                                **base) -> Tuple[C.SceneRFConfig, SceneRF]:
    """A Lightning `.ckpt` -> a checkpoint directory `out` that `load_model`
    and every CLI's `--model_path` take. Checks the weights against the
    config's model before anything is written. Returns (config, model on
    the CPU)."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    cfg = config_from_hparams(preset, raw.get("hyper_parameters", {}), **base)
    model = SceneRF(cfg)
    validate_against_model(model.state_dict(), W.reference_model_state(raw))
    W.load_reference_state_dict(model, raw)
    trainer = Trainer(cfg, device="cpu", model=model)
    # writes `best` too; no later value is worse than +inf
    CheckpointManager(out).save(trainer.state_dict(), cfg,
                                metrics={"depth/abs_rel": math.inf})
    return cfg, model.eval()


def save_reference_layout(path: str, state_dict: Mapping[str, torch.Tensor],
                          hparams: Mapping[str, Any]) -> None:
    """torch.save `state_dict` (the port's names, which are the reference's)
    as a published checkpoint lays it out: with a `num_batches_tracked`
    beside every BN's running stats and the unread keys of `_UNREAD` added,
    `hparams` under `hyper_parameters` and Lightning's counters."""
    sd = dict(state_dict)
    for k in state_dict:
        if k.endswith(".running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(1234)
    sd.update({k: torch.zeros(shape) for k, shape in _UNREAD.items()})
    sd[f"{W.ENCODER}.bn2.num_batches_tracked"] = torch.tensor(1234)
    torch.save({"state_dict": sd, "hyper_parameters": dict(hparams), "epoch": 1,
                "global_step": 6}, path)

