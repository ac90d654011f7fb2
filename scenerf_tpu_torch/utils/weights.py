"""Weights between the JAX package and the port.

`state_dict_from_jax_variables` maps the JAX `SceneRF.init` variables tree
(nested dicts of arrays) to this package's `state_dict`: the inverse of
`scenerf_tpu/utils/port_reference.py:85 port_reference_state_dict`, which
maps a reference (and so a port) `state_dict` to the JAX tree. Layouts:
dense kernel [in, out] -> weight [out, in]; conv HWIO -> OIHW (a depthwise
[kh, kw, 1, C] becomes [C, 1, kh, kw]); BN scale/bias -> weight/bias and
mean/var -> running_mean/running_var.

The mapping is only transposes and reshapes, so it is linear and maps a
gradient as it maps a weight: `numpy_grads_from_jax` renames a JAX gradient
tree (or any params-shaped tree) to the port's parameter names, and a
variables tree with updated `batch_stats` gives the port's running
statistics through `numpy_state_dict_from_jax_variables`.

`load_reference_state_dict` loads a reference Lightning `state_dict` and
skips exactly what the reference forward never uses (and
port_reference_state_dict never reads): the encoder's bn2 and classifier,
the decoder's resize_* convs, and BN batch counters.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, Any]

ENCODER = "net_rgb.encoder.original_model"
DECODER = "net_rgb.decoder"


def _conv(out: Dict, prefix: str, p: Tree) -> None:
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _linear(out: Dict, prefix: str, p: Tree) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _sub(s: Optional[Tree], key: str) -> Optional[Tree]:
    """A batch_stats subtree, None all the way down when there are none."""
    return None if s is None else s[key]


def _bn(out: Dict, prefix: str, p: Tree, s: Optional[Tree]) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    if s is not None:
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])


def _backbone(out: Dict, p: Tree, s: Optional[Tree]) -> None:
    if "conv_stem" not in p:  # TinyBackbone keeps the JAX names
        for name, leaf in p.items():
            _conv(out, f"{ENCODER}.{name}", leaf)
        return
    _conv(out, f"{ENCODER}.conv_stem", p["conv_stem"])
    _bn(out, f"{ENCODER}.bn1", p["bn1"], _sub(s, "bn1"))
    for name in p:
        m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if m is None:
            continue
        t = f"{ENCODER}.blocks.{m.group(1)}.{m.group(2)}"
        bp, bs = p[name], _sub(s, name)
        if "expand_conv" in bp:
            _conv(out, f"{t}.conv_pw", bp["expand_conv"])
            _bn(out, f"{t}.bn1", bp["expand_bn"], _sub(bs, "expand_bn"))
            _conv(out, f"{t}.conv_dw", bp["dw_conv"])
            _bn(out, f"{t}.bn2", bp["dw_bn"], _sub(bs, "dw_bn"))
            proj, proj_bn = "conv_pwl", "bn3"
        else:
            _conv(out, f"{t}.conv_dw", bp["dw_conv"])
            _bn(out, f"{t}.bn1", bp["dw_bn"], _sub(bs, "dw_bn"))
            proj, proj_bn = "conv_pw", "bn2"
        _conv(out, f"{t}.se.conv_reduce", bp["se_reduce"])
        _conv(out, f"{t}.se.conv_expand", bp["se_expand"])
        _conv(out, f"{t}.{proj}", bp["project_conv"])
        _bn(out, f"{t}.{proj_bn}", bp["project_bn"], _sub(bs, "project_bn"))
    _conv(out, f"{ENCODER}.conv_head", p["conv_head"])


def _decoder(out: Dict, p: Tree, s: Optional[Tree]) -> None:
    _conv(out, f"{DECODER}.conv2", p["conv2"])
    for up in ("up16", "up8", "up4", "up2", "up1"):
        _conv(out, f"{DECODER}.{up}._net.0", p[up]["conv"])
        for i in range(3):
            bp, bs = p[up][f"block{i}"], _sub(_sub(s, up), f"block{i}")
            b = f"{DECODER}.{up}._net.{i + 1}"
            _conv(out, f"{b}.conv_block1.0", bp["conv1"])
            _bn(out, f"{b}.conv_block1.1", bp["bn1"], _sub(bs, "bn1"))
            _conv(out, f"{b}.conv_block2.0", bp["conv2"])
            _bn(out, f"{b}.conv_block2.1", bp["bn2"], _sub(bs, "bn2"))


def _resnetfc(out: Dict, prefix: str, p: Tree) -> None:
    _linear(out, f"{prefix}.lin_in", p["lin_in"])
    _linear(out, f"{prefix}.lin_out", p["lin_out"])
    i = 0
    while f"block_{i}" in p:
        _linear(out, f"{prefix}.blocks.{i}.fc_0", p[f"block_{i}"]["fc_0"])
        _linear(out, f"{prefix}.blocks.{i}.fc_1", p[f"block_{i}"]["fc_1"])
        _linear(out, f"{prefix}.lin_z.{i}", p[f"lin_z_{i}"])
        i += 1


def numpy_state_dict_from_jax_variables(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX variables tree -> {port state_dict key: numpy array (a transposed
    view, nothing copied)}. Without net_rgb's "batch_stats" only the
    parameters are mapped."""
    out: Dict[str, np.ndarray] = {}
    net = variables["net_rgb"]
    stats = net.get("batch_stats")
    _backbone(out, net["params"]["backbone"],
              None if stats is None else stats.get("backbone", {}))
    _decoder(out, net["params"]["decoder"], _sub(stats, "decoder"))
    _resnetfc(out, "mlp", variables["mlp"]["params"])
    _resnetfc(out, "mlp_gaussian", variables["mlp_gaussian"]["params"])
    return out


def numpy_grads_from_jax(grads: Tree) -> Dict[str, np.ndarray]:
    """A params-shaped JAX tree {"net_rgb", "mlp", "mlp_gaussian"} (e.g. the
    gradient of a loss over the params) -> {port parameter name: array}."""
    return numpy_state_dict_from_jax_variables({k: {"params": v} for k, v in grads.items()})


def state_dict_from_jax_variables(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX variables tree -> the port's state_dict (f32 CPU tensors), ready
    for `load_state_dict(strict=True)`."""
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in numpy_state_dict_from_jax_variables(variables).items()}


def _skipped(key: str) -> bool:
    return (key.startswith((f"{ENCODER}.bn2.", f"{ENCODER}.classifier.",
                            f"{DECODER}.resize_"))
            or key.endswith(".num_batches_tracked"))


def reference_model_state(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference Lightning checkpoint's state_dict (or the checkpoint dict
    holding it) minus the keys the reference forward never reads: the port's
    state_dict keys, under the same names."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if not _skipped(k)}


def load_reference_state_dict(model: nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a reference Lightning checkpoint's state_dict (or the checkpoint
    dict holding it) into the port, strictly, minus the keys the reference
    forward never reads."""
    model.load_state_dict(reference_model_state(sd), strict=True)
