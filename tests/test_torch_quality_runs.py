"""The port's training-quality arm, `scripts/quality_runs_torch.py`, against
the JAX package's `scripts/quality_runs.py`:

* `write_val_voxel_anchors` writes files byte-equal to the JAX script's,
  and leaves a voxels directory that already holds files as it is;
* the arm grid's configs equal the JAX script's `make_cfg` grid field by
  field (the JAX grid's `remat_*` knobs, which the port does not have, left
  out);
* at the tiny preset on a small KITTI tree (tests/_torch_kitti_tree.py), two
  arms of two steps write JSON that scripts/quality_table.py reads, with
  finite values; the arms start from equal state dicts and read the same
  frames; the step-0 val equals the mean of `Trainer.depth_eval_step` over
  the same val items with the same draws.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_kitti_tree import REPO, write_kitti_tree
from scenerf_tpu import config as JC
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import train as train_mod
from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch
from scenerf_tpu_torch.model import SceneRF

torch.set_num_threads(1)

ARMS = ("bf16x2", "f32x2")
STEPS = 2


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


Q = load_script("quality_runs_torch")


def test_val_voxel_anchors_equal_jax(tmp_path):
    jax_script = load_script("quality_runs")
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert Q.write_val_voxel_anchors(a, n=10)
    jax_script.write_val_voxel_anchors(b, n=10)
    rel = "dataset/sequences/08/voxels"
    names = sorted(os.listdir(os.path.join(a, rel)))
    assert names == sorted(os.listdir(os.path.join(b, rel))) and len(names) == 6
    for n in names:
        with open(os.path.join(a, rel, n), "rb") as fa, open(os.path.join(b, rel, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_val_voxel_anchors_leave_existing_voxels(tmp_path):
    vox_dir = tmp_path / "dataset" / "sequences" / "08" / "voxels"
    vox_dir.mkdir(parents=True)
    label = np.random.default_rng(0).integers(0, 260, 256 * 256 * 32).astype(np.uint16)
    label.tofile(vox_dir / "000000.label")
    before = (vox_dir / "000000.label").read_bytes()
    assert not Q.write_val_voxel_anchors(str(tmp_path), n=10)
    assert os.listdir(vox_dir) == ["000000.label"]
    assert (vox_dir / "000000.label").read_bytes() == before


def test_arm_grid_matches_jax():
    grid = Q.arm_grid()
    assert set(grid) == {f"{d}x{n}" for d in ("bf16", "f32") for n in (1, 2, 4, 8)}
    for tag, cfg in grid.items():
        n = int(tag.split("x")[1])
        dtype = "bfloat16" if tag.startswith("bf16") else "float32"
        # the JAX script's make_cfg, less its remat_* knobs
        want = dataclasses.asdict(JC.kitti(n_sources=n, ray_chunk=1200, n_gt_depth=256,
                                           compute_dtype=dtype))
        for k, v in dataclasses.asdict(cfg).items():
            assert v == want[k], (tag, k)


def tiny_cfg(dtype, n_sources):
    return C.tiny(img_size=(1220, 370), n_sources=n_sources, compute_dtype=dtype)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """main() on a 6 + 7 frame tree at tiny widths: ARMS x STEPS steps, val
    every step; each arm's starting state dict."""
    root = write_kitti_tree(str(tmp_path_factory.mktemp("kitti")), {"00": 6, "08": 7})
    out = str(tmp_path_factory.mktemp("q") / "quality.json")
    starts = []

    class Recording(train_mod.Trainer):
        def __init__(self, cfg, *a, model=None, **kw):
            starts.append({k: v.clone() for k, v in model.state_dict().items()})
            super().__init__(cfg, *a, model=model, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Q, "make_cfg", tiny_cfg)
        mp.setattr(train_mod, "Trainer", Recording)
        results = Q.main(["--root", root, "--steps", str(STEPS), "--val_every", "1",
                          "--configs", ",".join(ARMS), "--out", out, "--device", "cpu"])
    return root, out, results, starts


def test_arms_write_json_quality_table_reads(arms, capsys):
    _, out, results, _ = arms
    with open(out) as f:
        assert json.load(f).keys() == results.keys() == set(ARMS)
    for tag, h in results.items():
        assert h["steps"] == list(range(STEPS + 1)), tag
        assert np.isfinite(h["val_abs_rel"] + h["val_rmse"] + h["train_loss"][1:]).all(), tag
        assert np.isnan(h["train_loss"][0]) and h["wall_s"] > 0 and h["peak_gib"] is None
    load_script("quality_table").main(out)
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith("| arm | seeds | best val abs_rel")
    for tag in ARMS:
        row = next(line for line in table if line.startswith(f"| {tag} | 1 |"))
        assert "nan" not in row, row


def test_arms_are_seed_matched(arms):
    _, _, results, starts = arms
    assert len(starts) == len(ARMS)
    a, b = starts
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ids = [results[t]["frame_ids"] for t in ARMS]
    assert len(ids[0]) == STEPS and ids[0] == ids[1]


def test_step0_val_is_the_depth_eval_mean(arms):
    root, _, results, starts = arms
    for tag, start in zip(ARMS, starts):
        cfg = tiny_cfg("bfloat16" if tag.startswith("bf16") else "float32", 2)
        model = SceneRF(cfg)
        model.load_state_dict(start)
        trainer = train_mod.Trainer(cfg, device="cpu", model=model)
        val = KittiDataset("val", root, os.path.join(root, "preprocess"), n_sources=2,
                           n_rays=cfg.n_gt_depth, seed=42)
        ms = [trainer.depth_eval_step(to_model_batch([val[i]], cfg),
                                      torch.Generator().manual_seed(Q.VAL_SEED + i))
              for i in range(min(Q.VAL_ITEMS, len(val)))]
        for key, name in (("val_abs_rel", "depth/abs_rel"), ("val_rmse", "depth/rmse")):
            want = sum(float(m[name]) for m in ms) / len(ms)
            np.testing.assert_allclose(results[tag][key][0], want, rtol=1e-6, err_msg=tag)
