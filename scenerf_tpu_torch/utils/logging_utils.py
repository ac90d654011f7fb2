"""Training metric log under the reference's scalar names:
{train,val}/loss_*, {train,val}depth/*, {train,val}_som/*. The port's own
copy of `scenerf_tpu/utils/logging_utils.py`.

It always appends JSON lines to `{logdir}/metrics.jsonl` (one object per
`log` call: {"step", "step_type", scalars...}, and {"step", "lr"} per
`log_lr`), and also writes TensorBoard scalars when tensorboardX imports.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

# model metric key -> scalar name ({} = step type)
_NAMESPACE = {
    "loss_reprojection": "{}/loss_reprojection",
    "loss_color": "{}/loss_color",
    "loss_som_kl": "{}/loss_som_kl",
    "loss_dist2closest_gauss": "{}/loss_dist2closest_gauss",
    "total_loss": "{}/total_loss",
    "min_som_vars": "{}/min_som_vars",
    "min_stds": "{}_som/closest_std",
    "closest_pts_to_depth": "{}depth/closest_pts_to_depth",
    "weights_at_depth": "{}depth/weights_at_depth",
}

# keys the reference logs under a second name as well
_ALIASES = {
    "loss_dist2closest_gauss": "{}_som/dist_2_closest_gaussian",
}


def scalar_name(key: str, step_type: str) -> str:
    if key in _NAMESPACE:
        return _NAMESPACE[key].format(step_type)
    if key.startswith("depth/"):
        return f"{step_type}depth/{key.removeprefix('depth/')}"
    return f"{step_type}/{key}"


class MetricLogger:
    def __init__(self, logdir: Optional[str] = None):
        """No `logdir`: log nothing."""
        self.writer = None
        self._jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = os.path.join(logdir, "metrics.jsonl")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(logdir)

    def _append_jsonl(self, record: Dict):
        if self._jsonl is not None:
            with open(self._jsonl, "a") as f:
                f.write(json.dumps(record) + "\n")

    def log(self, metrics: Dict[str, float], step: int, step_type: str = "train"):
        """Host scalars (floats) under their reference names."""
        record = {"step": int(step), "step_type": step_type}
        for k, v in metrics.items():
            v = float(v)
            record[scalar_name(k, step_type)] = v
            if self.writer is not None:
                self.writer.add_scalar(scalar_name(k, step_type), v, step)
                if k in _ALIASES:
                    self.writer.add_scalar(_ALIASES[k].format(step_type), v, step)
        self._append_jsonl(record)

    def log_lr(self, lr: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar("lr", float(lr), step)
        self._append_jsonl({"step": int(step), "lr": float(lr)})

    def close(self):
        if self.writer is not None:
            self.writer.close()
