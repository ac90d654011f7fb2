"""The port's own model checkpoint: one `torch.save` file holding the config
fields and the model's `state_dict`.

The JAX package's orbax checkpoint directories (`scenerf_tpu/utils/
checkpoint.py`, read by `scenerf_tpu/cli/common.py:31 load_model`) cannot be
read where the port runs: orbax needs JAX. Converting them (through
`utils/weights.state_dict_from_jax_variables`) is the data + checkpoint
slice's work (ROADMAP Queue 1 #6).
"""
from __future__ import annotations

import dataclasses

import torch

from scenerf_tpu_torch.config import SceneRFConfig, SphereConfig
from scenerf_tpu_torch.model import SceneRF


def save_checkpoint(path: str, model: SceneRF) -> None:
    """Write the model's config and weights (tensors moved to the CPU)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"config": dataclasses.asdict(model.cfg), "state_dict": state}, path)


def _config_from_fields(fields: dict) -> SceneRFConfig:
    fields = dict(fields)
    fields["sphere"] = SphereConfig(**fields["sphere"])
    return SceneRFConfig(**fields)


def load_model(path: str, device) -> SceneRF:
    """The checkpointed model on `device`, in eval mode."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    with torch.device(device):
        model = SceneRF(_config_from_fields(ckpt["config"]))
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return model.eval()
