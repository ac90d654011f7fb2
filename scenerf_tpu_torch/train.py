"""The training step: forward, backward and one AdamW update on one device.
Counterpart of `scenerf_tpu/train.py:53-66` (optimizer and schedule) and
`:149-187` (the step body) for a single device.

    trainer = Trainer(kitti(), steps_per_epoch=1000)      # on cuda:0
    metrics = trainer.train_step(make_batch(cfg), generator)

AdamW (betas 0.9/0.999, eps 1e-8, the config's weight decay, 0 by default
where torch's own default is 0.01) with the reference's per-epoch staircase
decay lr * gamma^(step // steps_per_epoch), set before each step as
`optax.exponential_decay(staircase=True)` evaluates it. The BN running
statistics move in train mode only. The step returns its metrics as device
tensors and never waits for the device.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.model import Noise, SceneRF
from scenerf_tpu_torch.ops.build import resolve_device


class Trainer:
    def __init__(self, cfg: SceneRFConfig, device=None, steps_per_epoch: int = 1000,
                 model: Optional[SceneRF] = None):
        """`model` (default: a fresh `SceneRF(cfg)` built on the device) is
        trained in place."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.steps_per_epoch = max(1, steps_per_epoch)
        if model is None:
            with torch.device(self.device):
                model = SceneRF(cfg)
        self.model = model.to(self.device)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)
        self.step = 0
        self._maps: Dict[bytes, Dict[int, torch.Tensor]] = {}

    def lr_at(self, step: int) -> float:
        """The staircase schedule: lr * gamma^(step // steps_per_epoch)."""
        return self.cfg.lr * self.cfg.lr_decay_gamma ** (step // self.steps_per_epoch)

    def device_batch(self, batch: Mapping[str, np.ndarray]):
        """(batch as f32 device tensors, the sphere maps of its first camera
        on the device, built on the host once per intrinsics)."""
        host_K = np.ascontiguousarray(batch["cam_K"][0], np.float32)
        key = host_K.tobytes()
        if key not in self._maps:
            self._maps[key] = {s: torch.as_tensor(m, device=self.device)
                               for s, m in self.model.compute_sphere_maps(host_K).items()}
        tensors = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                   for k, v in batch.items()}
        return tensors, self._maps[key]

    def train_step(self, batch: Mapping[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """One step on a host batch of numpy arrays (the contract of
        data/synthetic.py). The random draws come from `generator` (on the
        trainer's device) unless `noise` gives them all
        (`SceneRF.draw_noise`). Returns the metrics as device tensors."""
        tensors, maps = self.device_batch(batch)
        if noise is None:
            B, S_n = tensors["T_source2infer"].shape[:2]
            noise = self.model.draw_noise(B, S_n, generator, self.device)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.model(tensors, noise, train=True, sphere_maps=maps)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}
