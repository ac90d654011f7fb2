"""Convert a training checkpoint directory of the JAX package (orbax `last`
and `best` + `meta.json`, written by `scenerf_tpu.utils.checkpoint.
CheckpointManager`) into the port's (`scenerf_tpu_torch.utils.checkpoint.
CheckpointManager`: `torch.save` files `last` / `best` + `meta.json`).

    python scripts/convert_jax_checkpoint_torch.py JAX_CKPT_DIR OUT_DIR

Each converted file holds the config, the model's weights and BN running
statistics (through `utils/weights.state_dict_from_jax_variables`) and the
step; `meta.json` keeps `last_step`, `best_value` and `best_step`. The
config keeps the fields the port has (the JAX package's TPU knobs are
dropped). The AdamW state and the random-number state are NOT carried over:
the files load through `utils.checkpoint.load_model` (e.g. the
reconstruction CLI's `--model_path OUT_DIR`), but `train-kitti` cannot
resume from them.

The one file of the repository that imports both JAX (orbax) and the port:
run it where JAX is installed. Nothing of the port imports it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scenerf_tpu_torch.config import SceneRFConfig  # noqa: E402
from scenerf_tpu_torch.utils.checkpoint import config_from_fields  # noqa: E402
from scenerf_tpu_torch.utils.weights import state_dict_from_jax_variables  # noqa: E402


def convert(src: str, dst: str) -> list:
    """Write `dst`'s files from `src`'s; the names written."""
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    port_fields = {f.name for f in dataclasses.fields(SceneRFConfig)}
    cfg = config_from_fields({k: v for k, v in meta["config"].items() if k in port_fields})
    os.makedirs(dst, exist_ok=True)
    written = []
    for which in ("last", "best"):
        path = os.path.abspath(os.path.join(src, which))
        if not os.path.exists(path):
            continue
        tree = ocp.StandardCheckpointer().restore(path)
        variables = {k: {"params": v} for k, v in tree["params"].items()}
        variables["net_rgb"]["batch_stats"] = tree["batch_stats"]
        torch.save({"config": dataclasses.asdict(cfg),
                    "model": state_dict_from_jax_variables(variables),
                    "step": int(tree["step"])}, os.path.join(dst, which))
        written.append(which)
    out_meta = {"config": dataclasses.asdict(cfg),
                **{k: meta[k] for k in ("last_step", "best_value", "best_step") if k in meta}}
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(out_meta, f, indent=2)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the JAX package's checkpoint directory")
    p.add_argument("dst", help="the port's checkpoint directory to write")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    written = convert(args.src, args.dst)
    print(f"converted {written} from {args.src} to {args.dst}")


if __name__ == "__main__":
    main()
