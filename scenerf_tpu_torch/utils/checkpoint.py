"""The port's checkpoints, as `torch.save` files read with
`torch.load(weights_only=True)`.

- `save_checkpoint(path, model)`: one file holding the config fields and
  the model's `state_dict`.
- `CheckpointManager(directory)`: what training keeps, the counterpart of
  `scenerf_tpu/utils/checkpoint.py:37-100`. `last` holds the trainer's state
  after each validation epoch (the model, the AdamW state, the step and the
  training generator's state, `train.Trainer.state_dict`) and the config;
  `best` the same at the best value so far of the monitored metric
  (`depth/abs_rel`, lower is better, by default); `meta.json` the config's
  fields, `last_step`, `best_value` and `best_step`. Each file is written to
  a temporary name and renamed over the old one, so a run killed during a
  save leaves the previous checkpoint readable; a new `best` is a hard link
  to the new `last` where the file system has them (a copy else).

`load_model` reads either kind: a `save_checkpoint` file, a manager's
`last` / `best` file, or a manager's directory (its `best`, else `last`).
The JAX package's orbax directories need JAX to read:
`scripts/convert_jax_checkpoint_torch.py` converts them where JAX is.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from scenerf_tpu_torch.config import SceneRFConfig, SphereConfig
from scenerf_tpu_torch.model import SceneRF


def _replace_file(path: str, write) -> None:
    """`write(tmp_path)`, then rename the temporary file over `path`."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, model: SceneRF) -> None:
    """Write the model's config and weights (tensors moved to the CPU)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _replace_file(path, lambda p: torch.save(
        {"config": dataclasses.asdict(model.cfg), "state_dict": state}, p))


def config_from_fields(fields: Mapping[str, Any]) -> SceneRFConfig:
    """A config from `dataclasses.asdict` fields (tuples may come back as
    lists from JSON)."""
    fields = dict(fields)
    fields["sphere"] = SphereConfig(**fields["sphere"])
    for k in ("img_size", "scene_size", "vox_origin"):
        fields[k] = tuple(fields[k])
    return SceneRFConfig(**fields)


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "depth/abs_rel", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: 'min' or 'max'")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.last_path = os.path.join(self.directory, "last")
        self.best_path = os.path.join(self.directory, "best")
        self.meta_path = os.path.join(self.directory, "meta.json")

    def read_meta(self) -> Dict[str, Any]:
        if not os.path.exists(self.meta_path):
            return {}
        with open(self.meta_path) as f:
            return json.load(f)

    def save(self, state: Mapping[str, Any], cfg: SceneRFConfig,
             metrics: Optional[Mapping[str, float]] = None) -> bool:
        """Save `state` (`Trainer.state_dict()`) as `last`, and as `best` if
        `metrics[monitor]` improves on the best so far; then `meta.json`.
        Returns whether `best` was written."""
        ckpt = {**state, "config": dataclasses.asdict(cfg)}
        _replace_file(self.last_path, lambda p: torch.save(ckpt, p))
        meta = self.read_meta()
        meta["config"] = dataclasses.asdict(cfg)
        meta["last_step"] = int(state["step"])
        improved = False
        if metrics and self.monitor in metrics:
            value = float(metrics[self.monitor])
            best = meta.get("best_value")
            improved = best is None or (value < best if self.mode == "min" else value > best)
            if improved:
                _replace_file(self.best_path, lambda p: _link_or_copy(self.last_path, p))
                meta["best_value"] = value
                meta["best_step"] = int(state["step"])
        _replace_file(self.meta_path, lambda p: _write_json(p, meta))
        return improved

    def latest(self) -> Optional[str]:
        return self.last_path if os.path.exists(self.last_path) else None

    def best(self) -> Optional[str]:
        return self.best_path if os.path.exists(self.best_path) else None

    def restore(self, which: str = "last") -> Dict[str, Any]:
        """The saved trainer state (on the host) with its "config" fields."""
        path = {"last": self.last_path, "best": self.best_path}[which]
        return torch.load(path, map_location="cpu", weights_only=True)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def load_model(path: str, device) -> SceneRF:
    """The checkpointed model on `device`, in eval mode: from a
    `save_checkpoint` file, a manager's `last` / `best`, or a manager's
    directory (its `best`, else its `last`)."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        path = mgr.best() or mgr.latest()
        if path is None:
            raise FileNotFoundError(f"no best or last checkpoint under {mgr.directory}")
    # mmap: of a manager's file only the model's tensors are read
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    state = ckpt["state_dict"] if "state_dict" in ckpt else ckpt["model"]
    with torch.device(device):
        model = SceneRF(config_from_fields(ckpt["config"]))
    model.load_state_dict(state, strict=True)
    return model.eval()
