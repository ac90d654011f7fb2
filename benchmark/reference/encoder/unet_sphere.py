"""UNet2DSphere: backbone + spherical decoder, giving five channel-last levels.
Counterpart of `scenerf_tpu/encoder/unet_sphere.py`; the backbone sits at
`encoder.original_model`, as in the reference checkpoint layout."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .backbones import make_backbone
from .sphere_decoder import DecoderSphere, decoder_latent_dim


class _EncoderWrapper(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.original_model = backbone


class UNet2DSphere(nn.Module):
    def __init__(self, backbone_name: str = "effnet-b7", num_features: int = 2560,
                 bn_momentum: float = 0.99, dtype: Optional[torch.dtype] = None):
        """`dtype`: the compute dtype of every conv, resample and batch norm
        (parameters and batch-norm statistics stay f32)."""
        super().__init__()
        backbone = make_backbone(backbone_name, num_features=num_features,
                                 bn_momentum=bn_momentum, dtype=dtype)
        self.encoder = _EncoderWrapper(backbone)
        self.decoder = DecoderSphere(num_features, backbone.tap_channels, dtype)
        self.d_latent = decoder_latent_dim(num_features)

    def forward(self, img: torch.Tensor, maps: Dict[int, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """img [B, H, W, 3] -> levels {"1_1".."1_16": contiguous [B, H_s, W_s, C_s]}."""
        taps = self.encoder.original_model(img)
        levels = self.decoder(taps, maps)
        return {k: v.contiguous() for k, v in levels.items()}
