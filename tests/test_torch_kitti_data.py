"""The port's KITTI data slice against the JAX package's on one small tree
(`_torch_kitti_tree.py`: sequence 00 with 6 frames, val sequence 08 with 7):
LiDAR reading and projection, every item of `KittiDataset(n_sources=2,
seed=42)` (each package computing its own ICP into its own preprocess
tree), ICP itself, the transform cache read across the packages,
`to_model_batch` with padded sources, and the loader's order, length,
batches and error path. Every comparison is equality: the port computes
with the same numpy operations and the same C++ source built with the same
g++ flags (ICP within 1e-9, measured equal).
"""
import os
import threading

import numpy as np
import pytest
import torch

from _torch_kitti_tree import write_kitti_tree
from scenerf_tpu import config as JC
from scenerf_tpu.data import calib as jcalib
from scenerf_tpu.data import icp as jicp
from scenerf_tpu.data.kitti import KittiDataset as JaxKitti
from scenerf_tpu.data.kitti import to_model_batch as jax_to_model_batch
from scenerf_tpu.data.loader import DataLoader as JaxLoader
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data import calib, icp
from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch
from scenerf_tpu_torch.data.loader import DataLoader
from scenerf_tpu_torch.native import build as native_build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kitti_tree(str(tmp_path_factory.mktemp("kitti")), {"00": 6, "08": 7})


def assert_items_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
                assert np.asarray(a).dtype == np.asarray(b).dtype, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert np.asarray(g).dtype == np.asarray(w).dtype, k


def test_read_lidar_and_lidar_to_depth_equal_jax(tree):
    seq = os.path.join(tree, "dataset", "sequences", "00")
    cal = calib.read_calib(os.path.join(seq, "calib.txt"))
    T = cal["T_cam0_2_cam2"] @ cal["Tr"]
    for i in range(3):
        path = os.path.join(seq, "velodyne", f"{i:06d}.bin")
        pts = calib.read_lidar(path)
        np.testing.assert_array_equal(pts, jcalib.read_lidar(path))
        assert pts.dtype == np.float32 and pts.shape[1] == 4
        for max_depth in (80.0, 20.0):
            got = calib.lidar_to_depth(pts, cal["P2"], T, (1220, 370), max_depth=max_depth)
            want = jcalib.lidar_to_depth(pts, cal["P2"], T, (1220, 370), max_depth=max_depth)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
            assert 0 < len(got[1]) < len(pts) and (got[0] > 0).all() and got[1].max() <= max_depth


@pytest.mark.parametrize("split", ["train", "val"])
def test_items_equal_jax(tree, tmp_path, split):
    kw = dict(n_sources=2, seed=42, n_rays=500, load_voxels=split == "val")
    seqs = ["00"] if split == "train" else None
    ours = KittiDataset(split, tree, str(tmp_path / "port"), sequences=seqs, **kw)
    theirs = JaxKitti(split, tree, str(tmp_path / "jax"), sequences=seqs, **kw)
    assert [s["frame_id"] for s in ours.scans] == [s["frame_id"] for s in theirs.scans]
    assert len(ours) == {"train": 5, "val": 1}[split]
    for i in range(len(ours)):
        assert_items_equal(ours[i], theirs[i])
    # each package computed its own transforms
    assert os.listdir(tmp_path / "port" / "transform") == os.listdir(tmp_path / "jax" / "transform")


def test_compute_transformation_matches_jax(tree):
    ds = KittiDataset("train", tree, "", n_sources=0, sequences=["00"])
    s = ds.scans[0]
    args = (s["lidar_paths"][2], s["lidar_paths"][0], s["lidar_paths"][1], s["poses"][2],
            s["poses"][0], s["poses"][1], s["T_velo_2_cam"], s["T_cam0_2_cam2"])
    got, want = icp.compute_transformation(*args), jicp.compute_transformation(*args)
    for k in ("T_source2infer", "T_source2target"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
        R = got[k][:3, :3]
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)
    # the port's library lives under build/native, not in either source tree
    lib = native_build._build()
    assert lib.parent == native_build.BUILD_DIR and lib.parent.parts[-2:] == ("build", "native")


def test_transform_cache_is_read_across_packages(tmp_path):
    def never():
        raise AssertionError("the cached value was recomputed")

    value = {"T_source2infer": np.arange(16.0).reshape(4, 4),
             "T_source2target": np.eye(4) * 2}
    for writer, reader in ((jicp.TransformCache, icp.TransformCache),
                           (icp.TransformCache, jicp.TransformCache)):
        root = str(tmp_path / writer.__module__)
        writer(root, "00", 0.4).get_or_compute("000003", 2, lambda: value)
        cache = reader(root, "00", 0.4)
        assert cache.path("000003") == os.path.join(root, "00_0.4_all", "000003.pkl")
        got = cache.get_or_compute("000003", 2, never)
        for k in value:
            np.testing.assert_array_equal(got[k], value[k])
        assert list(cache.load("000003")) == ["2"]


def test_to_model_batch_equal_jax(tree, tmp_path):
    """Three source slots for two sources (the third padded with identity
    poses) and 64 LiDAR rows where the items hold more (cut) and 3000 where
    they hold fewer (padded, masked)."""
    kw = dict(n_sources=2, seed=7, sequences=["00"], n_rays=2000)
    ours = KittiDataset("train", tree, str(tmp_path), **kw)
    theirs = JaxKitti("train", tree, str(tmp_path), **kw)
    items, jitems = [ours[0], ours[4]], [theirs[0], theirs[4]]
    for G in (64, 3000):
        got = to_model_batch(items, C.tiny(n_sources=3, n_gt_depth=G))
        want = jax_to_model_batch(jitems, JC.tiny(n_sources=3, n_gt_depth=G))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        assert (got["source_mask"][:, 2] == 0).all() and (got["T_source2infer"][:, 2] == np.eye(4)).all()


class Items:
    """A dataset of its indices, counting the reads."""

    def __init__(self, n: int, fail_at: int = -1):
        self.n, self.fail_at, self.reads = n, fail_at, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"item {i} is unreadable")
        self.reads.append(i)
        return {"i": i}


def collate(items):
    return {"i": np.array([it["i"] for it in items])}


@pytest.mark.parametrize("shuffle, limit, bs, drop_last", [
    (True, 0.5, 1, True), (True, 1.0, 3, True), (True, 1.0, 3, False), (False, 0.7, 2, False)])
def test_loader_order_len_and_batches_equal_jax(shuffle, limit, bs, drop_last):
    kw = dict(batch_size=bs, shuffle=shuffle, drop_last=drop_last, limit_fraction=limit, seed=5)
    ours, theirs = DataLoader(Items(23), collate, **kw), JaxLoader(Items(23), collate, **kw)
    assert len(ours) == len(theirs)
    for _ in range(3):  # one shuffle per epoch, in the same order
        got, want = [b["i"].tolist() for b in ours], [b["i"].tolist() for b in theirs]
        assert got == want and len(got) == len(ours)
    assert len(ours.timings["read_s"]) == len(ours.timings["wait_s"]) == len(ours)
    capped = DataLoader(Items(23), collate, max_batches=2, **kw)
    full = [b["i"].tolist() for b in DataLoader(Items(23), collate, **kw)]
    assert len(capped) == min(2, len(full)) and [b["i"].tolist() for b in capped] == full[:2]
    # the thread reads no item past the last batch
    assert sorted(capped.dataset.reads) == sorted(i for b in full[:2] for i in b)


def test_loader_raises_a_worker_error_and_stops_its_thread():
    loader = DataLoader(Items(10, fail_at=4), collate, batch_size=2, shuffle=False)
    seen = []
    with pytest.raises(KeyError, match="item 4 is unreadable"):
        for b in loader:
            seen.append(b["i"].tolist())
    assert seen == [[0, 1], [2, 3]]
    before = threading.active_count()
    for b in DataLoader(Items(40), collate, prefetch=1):
        break  # leaving early stops and joins the thread
    assert threading.active_count() == before
