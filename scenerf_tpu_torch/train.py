"""The training, validation and depth-eval steps, and the trainer's state.
Counterpart of `scenerf_tpu/train.py:53-66` (optimizer and schedule),
`:68-187` (the parallel modes and the step body) and `:259-282` (the val and
depth-eval steps).

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

Several ranks (`group`, a `torch.distributed` process group of W ranks,
`parallel/dist.py`; None: one rank, the path above unchanged). Every rank
starts from rank 0's weights, buffers and AdamW state; after each backward
the gradients are averaged over the ranks (one all-reduce: JAX's
`pmean(grads)`), so the ranks take the same AdamW step and stay equal, and
so are the metrics. The modes, as JAX's `Trainer`:
- data (default): each rank steps on its own items (its slice of the global
  batch), and every batch norm of the encoder and decoder reduces its
  training statistics over the ranks (kernel K5's synced path);
- `ray_parallel`: every rank holds the same items and draws its own rays;
- `ray_shard`: every rank holds the same items and the same draws, and
  renders its 1/W of each source's rays and GT rows (`SceneRF.forward`'s
  `ray_group`): the step equals the one-rank step up to the order of f32
  sums. A step raises unless W divides n_rays (and n_gt_depth, with depth
  eval).
The draws: in data and ray_parallel modes rank r > 0 has its own generator,
seeded from (seed, r) (JAX folds the device index into the key); rank 0's,
and every rank's in ray_shard, is seeded with `seed` as on one rank. In the
two ray modes the inputs of every batch norm are the same on every rank, so
the batch statistics are too: they are not synced (JAX's pmean of equal
values).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.encoder.norm import set_sync_group
from scenerf_tpu_torch.model import Noise, SceneRF, to_device
from scenerf_tpu_torch.ops.build import resolve_device
from scenerf_tpu_torch.parallel import dist as D
from scenerf_tpu_torch.utils import tracing

MODES = ("data", "ray_parallel", "ray_shard")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s draws: `seed` itself on rank 0."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class Trainer:
    def __init__(self, cfg: SceneRFConfig, device=None, steps_per_epoch: int = 1000,
                 model: Optional[SceneRF] = None, seed: int = 0, group=None,
                 mode: str = "data"):
        """`model` (default: a fresh `SceneRF(cfg)` built on the device) is
        trained in place. `group` and `mode` (one of MODES): the ranks and
        how they share the work (the module docstring)."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.group, self.mode = group, mode
        self.world, self.rank = D.size(group), D.rank(group)
        if model is None:
            with torch.device(self.device):
                model = SceneRF(cfg)
        self.model = model.to(self.device)
        set_sync_group(self.model.net_rgb, group if mode == "data" else None)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)
        D.broadcast_module(self.model, self.optimizer, group)
        self.step = 0
        self.generator = torch.Generator().manual_seed(self.draw_seed(seed))
        self._maps: Dict[bytes, Dict[int, torch.Tensor]] = {}

    @property
    def ray_group(self):
        """The group whose ranks split each source's rays (ray_shard)."""
        return self.group if self.mode == "ray_shard" else None

    def draw_seed(self, seed: int) -> int:
        """This rank's seed for draws seeded `seed` on one rank (the module
        docstring)."""
        return seed if self.mode == "ray_shard" else rank_seed(seed, self.rank)

    def lr_at(self, step: int) -> float:
        """The staircase schedule: lr * gamma^(step // steps_per_epoch)."""
        return self.cfg.lr * self.cfg.lr_decay_gamma ** (step // self.steps_per_epoch)

    def device_batch(self, batch: Mapping[str, np.ndarray]):
        """(batch as f32 device tensors, the sphere maps of its first camera
        on the device, built on the host once per intrinsics)."""
        with tracing.span("upload"):
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
        with tracing.span("train_step", self.step):
            tensors, maps = self.device_batch(batch)
            noise = self._noise(tensors, generator or self.generator, noise)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_at(self.step)
            self.optimizer.zero_grad(set_to_none=True)
            loss, metrics = self.model(tensors, noise, train=True, sphere_maps=maps,
                                       ray_group=self.ray_group)
            with tracing.span("backward"):
                loss.backward()
            D.average_gradients(list(self.model.parameters()), self.group)
            with tracing.span("adamw"):
                self.optimizer.step()
            self.step += 1
            return D.all_reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                        self.group)

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
                                with_losses=with_losses, ray_group=self.ray_group)
        return D.all_reduce_metrics(metrics, self.group)

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
        state, on the host; over several ranks (a collective: every rank
        calls it) also every rank's generator state, in rank order."""
        state = {"model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                 "optimizer": self.optimizer.state_dict(), "step": self.step,
                 "generator": self.generator.get_state()}
        if self.group is not None:
            gens = [None] * self.world
            torch.distributed.all_gather_object(gens, state["generator"], group=self.group)
            state["generators"] = gens
        return state

    def load_state_dict(self, state: Mapping) -> None:
        """Resume from `state_dict()`'s record; over several ranks each takes
        its own generator state (the record must be of as many ranks)."""
        gen = state["generator"]
        if self.group is not None:
            gens = state.get("generators")
            if gens is None or len(gens) != self.world:
                raise ValueError(f"the checkpoint holds the draws of "
                                 f"{1 if gens is None else len(gens)} ranks, not "
                                 f"{self.world}")
            gen = gens[self.rank]
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(gen)
