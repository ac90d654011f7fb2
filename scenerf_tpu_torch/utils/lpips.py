"""LPIPS (the VGG16 variant) as a PyTorch module: the novel-view metric of
`eval-color`, following `scenerf_tpu/utils/lpips.py`.

Both images are normalized by the fixed `SHIFT` / `SCALE`, pass through the
13 3x3 convs of VGG16 (ReLU after each, 2x2 max-pool between the five
stages), and are compared at the last ReLU of each stage (relu1_2 ..
relu5_3): each tap's channels scaled to unit norm (eps 1e-10), the squared
difference weighted per channel by the tap's linear layer and summed over
channels, its spatial mean summed over the taps. The convs are `F.conv2d`
in f32 with TF32 off, so a score on the card agrees with one on the CPU.

The weights load only from files the caller names; nothing is downloaded:

    LPIPS.from_npz(path, device)       # the JAX package's converted npz
    LPIPS.from_torch_checkpoint(vgg_path, lpips_path, device)
        # torchvision vgg16's state dict (features.{0,2,5,...,28}) and the
        # lpips package's LPIPS(net="vgg") one (lin{i}.model.1.weight or
        # lins.{i}.model.1.weight)
    LPIPS.random_init(generator, device)  # tests only: not a valid metric
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out channels, convs) per stage; a tap after the last ReLU of each stage
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# the 13 convs' indices in torchvision's vgg16 `features`
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
EPS = 1e-10


class LPIPS(nn.Module):
    def __init__(self, device="cpu"):
        super().__init__()
        convs, c_in = [], 3
        for ch, n in VGG_STAGES:
            for _ in range(n):
                convs.append(nn.Conv2d(c_in, ch, 3, padding=1, device=device))
                c_in = ch
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(ch, device=device), requires_grad=False)
             for ch, _ in VGG_STAGES])
        self.register_buffer("shift", torch.tensor(SHIFT, device=device).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE, device=device).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, 3, H, W] in [-1, 1] -> the five taps [N, C_s, H_s, W_s]."""
        x = (x - self.shift) / self.scale
        taps, ci = [], 0
        for si, (_, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                x = F.relu(self.convs[ci](x))
                ci += 1
            taps.append(x)
            if si < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """img1, img2: [H, W, 3] in [-1, 1] (the caller scales, as the
        reference does), on the module's device -> a scalar distance."""
        x = torch.stack([img1, img2]).permute(0, 3, 1, 2).float()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                taps = self.taps(x)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = x.new_zeros(())
        for t, w in zip(taps, self.lins):
            t = t / torch.sqrt(torch.sum(t * t, dim=1, keepdim=True) + EPS)
            d = (t[0] - t[1]) ** 2
            total = total + torch.mean(torch.sum(d * w[:, None, None], dim=0))
        return total

    # -------------------------------------------------------------- loaders
    def _load(self, kernels: Sequence[np.ndarray], biases: Sequence[np.ndarray],
              lins: Sequence[np.ndarray]) -> "LPIPS":
        """Kernels [O, I, 3, 3], biases [O] and the taps' weights [C]."""
        for conv, k, b in zip(self.convs, kernels, biases, strict=True):
            conv.weight.copy_(torch.as_tensor(np.asarray(k, np.float32)))
            conv.bias.copy_(torch.as_tensor(np.asarray(b, np.float32)))
        for lin, w in zip(self.lins, lins, strict=True):
            lin.copy_(torch.as_tensor(np.asarray(w, np.float32).reshape(-1)))
        return self

    @classmethod
    @torch.no_grad()
    def from_npz(cls, path: str, device="cpu") -> "LPIPS":
        """The JAX package's npz: conv{i}_kernel [3, 3, I, O] (HWIO),
        conv{i}_bias, lin{i}."""
        z = np.load(path)
        n = len(TORCHVISION_CONVS)
        return cls(device)._load([z[f"conv{i}_kernel"].transpose(3, 2, 0, 1) for i in range(n)],
                                 [z[f"conv{i}_bias"] for i in range(n)],
                                 [z[f"lin{i}"] for i in range(len(VGG_STAGES))])

    @classmethod
    @torch.no_grad()
    def from_torch_checkpoint(cls, vgg_state_path: str, lpips_state_path: str,
                              device="cpu") -> "LPIPS":
        """torchvision vgg16's state dict and the lpips package's."""
        vgg = torch.load(vgg_state_path, map_location="cpu", weights_only=True)
        lp = torch.load(lpips_state_path, map_location="cpu", weights_only=True)
        lins = []
        for i in range(len(VGG_STAGES)):
            key = next((k for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
                        if k in lp), None)
            if key is None:
                raise KeyError(f"no linear weight for tap {i} in {lpips_state_path}")
            lins.append(lp[key].numpy())
        return cls(device)._load([vgg[f"features.{t}.weight"].numpy() for t in TORCHVISION_CONVS],
                                 [vgg[f"features.{t}.bias"].numpy() for t in TORCHVISION_CONVS],
                                 lins)

    @classmethod
    @torch.no_grad()
    def random_init(cls, generator: torch.Generator, device="cpu") -> "LPIPS":
        """Seeded random weights (fan-in scaled kernels, small biases,
        positive tap weights): the architecture only, for tests."""
        kernels, biases, c_in = [], [], 3
        for ch, n in VGG_STAGES:
            for _ in range(n):
                kernels.append(torch.randn(ch, c_in, 3, 3, generator=generator).numpy()
                               / np.sqrt(9 * c_in))
                biases.append(0.01 * torch.randn(ch, generator=generator).numpy())
                c_in = ch
        lins = [torch.rand(ch, generator=generator).numpy() * 2 / ch for ch, _ in VGG_STAGES]
        return cls(device)._load(kernels, biases, lins)

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The weights in torchvision's and lpips' layouts ({"vgg": ...,
        "lpips": ...}), as `from_torch_checkpoint` reads them."""
        vgg = {}
        for t, conv in zip(TORCHVISION_CONVS, self.convs):
            vgg[f"features.{t}.weight"] = conv.weight.detach().cpu().clone()
            vgg[f"features.{t}.bias"] = conv.bias.detach().cpu().clone()
        lp = {f"lin{i}.model.1.weight": w.detach().cpu().clone().view(1, -1, 1, 1)
              for i, w in enumerate(self.lins)}
        return {"vgg": vgg, "lpips": lp}
