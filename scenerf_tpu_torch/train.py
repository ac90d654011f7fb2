"""The training, validation and depth-eval steps on one device, and the
trainer's state. Counterpart of `scenerf_tpu/train.py:53-66` (optimizer and
schedule), `:149-187` (the step body) and `:259-282` (the val and depth-eval
steps) for a single device.

    trainer = Trainer(kitti(), steps_per_epoch=1000)      # on cuda:0
    metrics = trainer.train_step(make_batch(cfg))
    val = trainer.val_step(make_batch(cfg), generator)

AdamW (betas 0.9/0.999, eps 1e-8, the config's weight decay, 0 by default
where torch's own default is 0.01) with the reference's per-epoch staircase
decay lr * gamma^(step // steps_per_epoch), set before each step as
`optax.exponential_decay(staircase=True)` evaluates it. The BN running
statistics move in train mode only. Every step returns its metrics as
device tensors and never waits for the device.

The training draws come from the trainer's generator, a host generator
seeded with `seed` (so a seed gives the same draws on the CPU and on the
card), unless a step is given its own. `state_dict()` holds what a resumed run
needs to continue bit for bit: the model's parameters and BN statistics,
the AdamW state, the step and the generator's state, every value a tensor
or a plain Python scalar (so `torch.load(weights_only=True)` reads it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.model import Noise, SceneRF, to_device
from scenerf_tpu_torch.ops.build import resolve_device


class Trainer:
    def __init__(self, cfg: SceneRFConfig, device=None, steps_per_epoch: int = 1000,
                 model: Optional[SceneRF] = None, seed: int = 0):
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
        self.generator = torch.Generator().manual_seed(seed)
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
        tensors = {k: to_device(torch.as_tensor(v, dtype=torch.float32), self.device)
                   for k, v in batch.items()}
        return tensors, self._maps[key]

    def train_step(self, batch: Mapping[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """One step on a host batch of numpy arrays (the contract of
        data/synthetic.py). The random draws come from `generator` (the
        trainer's own when None) unless `noise` gives them all
        (`SceneRF.draw_noise`). Returns the metrics as device
        tensors."""
        tensors, maps = self.device_batch(batch)
        noise = self._noise(tensors, generator or self.generator, noise)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.model(tensors, noise, train=True, sphere_maps=maps)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _noise(self, tensors, generator: torch.Generator, noise: Optional[Noise]) -> Noise:
        if noise is not None:
            return noise
        B, S_n = tensors["T_source2infer"].shape[:2]
        return self.model.draw_noise(B, S_n, generator, self.device)

    @torch.no_grad()
    def _eval(self, batch, generator, noise, with_losses: bool) -> Dict[str, torch.Tensor]:
        tensors, maps = self.device_batch(batch)
        noise = self._noise(tensors, generator, noise)
        _, metrics = self.model(tensors, noise, train=False, sphere_maps=maps,
                                with_losses=with_losses)
        return metrics

    def val_step(self, batch: Mapping[str, np.ndarray], generator: torch.Generator,
                 noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """The validation forward (BN on its running statistics, no gradient):
        losses, logs and the GT-depth metrics, as device tensors. Its draws
        come from `generator` (or `noise`): the same generator state gives
        the same metrics whenever it runs."""
        return self._eval(batch, generator, noise, with_losses=True)

    def depth_eval_step(self, batch: Mapping[str, np.ndarray], generator: torch.Generator,
                        noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """The GT-depth metrics alone (no training render), as device
        tensors: from the same draws, equal to `val_step`'s depth metrics."""
        return self._eval(batch, generator, noise, with_losses=False)

    def state_dict(self) -> Dict:
        """The model, the AdamW state, the step and the training generator's
        state, on the host."""
        return {"model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
