"""The port's BundleFusion data slice and its host pieces against the JAX
package's, on a fake tree of all 8 scenes (`scripts/make_fake_bf.py` at
64x48, 10 frames each; windows of `n_frames` 4 at `frame_interval` 1, so
each scene has 3 infer frames):

- every item of `BundlefusionDataset` (all splits; every source in order,
  and sources drawn at random), fetched in the same order from both
  packages, and `to_model_batch`: exactly equal, images, depths (PIL
  against imageio), poses, `cam_K` / `cam_K_depth`, source ids and `gt_pix`;
- the depth-PNG and pose readers, the splits and the error frames;
- `sample_rel_poses_bf` and `determine_angles` (also through the
  `determine-angles` command): equal;
- marching cubes ("mc" and "tetra") and `TSDFVolume.get_mesh` /
  `get_point_cloud`: bit-equal (the same C++ source, built with the same
  g++ flags);
- `generate-sc-gt-bf` on the CPU (kernel T's plain version) against the JAX
  command: tsdf grids equal except at voxels where some source projects
  within 1e-4 px of a .5 rounding boundary (at most 0.1% of the grid), and
  the occupancy equal wherever the grids are; `eval-sc-bf`'s IoU, precision
  and recall equal on the same files;
- the depth visual's colormap (read from a file, without matplotlib)
  against matplotlib's, pixel for pixel.
"""
import os
import pickle

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from scenerf_tpu import config as JC
from scenerf_tpu import geometry as jgeo
from scenerf_tpu.cli import common as jcommon
from scenerf_tpu.cli import evaluation as jeval
from scenerf_tpu.cli import reconstruction as jrecon
from scenerf_tpu.data import bundlefusion as jbf
from scenerf_tpu.fusion import meshing as jmesh
from scenerf_tpu.fusion import tsdf as jtsdf
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.cli import evaluation as ecli
from scenerf_tpu_torch.cli import reconstruction as rcli
from scenerf_tpu_torch.data import bundlefusion as bf
from scenerf_tpu_torch.fusion import meshing, tsdf
from scenerf_tpu_torch.ops.tsdf import pixel_ties
from scripts.make_fake_bf import write_fake_bf

torch.set_num_threads(1)

SIZE = (64, 48)
WINDOW = ["--frame_interval", "1", "--n_frames", "4"]
TIE_PX = 1e-4
MAX_TIE_SHARE = 1e-3


@pytest.fixture(scope="module")
def bf_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bf"))
    write_fake_bf(root, frames=10, size=SIZE, scenes=tuple(bf.SPLITS["all"]))
    return root


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


def test_splits_and_error_frames_equal_jax(bf_root):
    assert bf.SPLITS == jbf.SPLITS
    ours = bf.BundlefusionDataset("val", bf_root, frame_interval=1, n_frames=4)
    theirs = jbf.BundlefusionDataset("val", bf_root, frame_interval=1, n_frames=4)
    assert ours.error_frames == theirs.error_frames and len(ours.error_frames) > 600


def test_readers_equal_jax(bf_root, tmp_path):
    """Every depth PNG of copyroom, and one with zeros and 65535, through PIL
    and imageio; poses (and one in scientific notation) and intrinsics."""
    seq = os.path.join(bf_root, "copyroom")
    depth = np.zeros((5, 7), np.uint16)
    depth[1:, 2:] = np.arange(20, dtype=np.uint16).reshape(4, 5) * 2731 + 1
    depth[4, 6] = 65535
    Image.fromarray(depth, mode="I;16").save(tmp_path / "frame-000000.depth.png")
    paths = sorted(os.path.join(seq, f) for f in os.listdir(seq) if f.endswith("depth.png"))
    for path in paths + [str(tmp_path / "frame-000000.depth.png")]:
        got, want = bf.read_depth(path), jbf.read_depth(path)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bf.read_depth(str(tmp_path / "frame-000000.depth.png")),
                                  depth / 1000.0)
    with open(tmp_path / "pose.txt", "w") as f:
        f.write("0.99 -1.5e-3 2.0E-2 -3.25\n1e-5 1 0 .5\n-0.02 0 0.9998 12\n0 0 0 1\n")
    for path in [str(tmp_path / "pose.txt")] + [p.replace("depth.png", "pose.txt")
                                                for p in paths]:
        np.testing.assert_array_equal(bf.read_pose(path), jbf.read_pose(path))
    for got, want in zip(bf.read_camera_params(os.path.join(seq, "info.txt")),
                         jbf.read_camera_params(os.path.join(seq, "info.txt"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split,n_sources,seed", [("val", 1000, 0), ("val", 1, 3),
                                                  ("train", 2, 42), ("train", 0, 42)])
def test_items_equal_jax(bf_root, split, n_sources, seed):
    """All items, then some again in another order (the draws go on from
    the same generator state): equal. With every source, source 0's target
    is the window's last frame (`rel[-1]`)."""
    kw = dict(n_sources=n_sources, frame_interval=1, n_frames=4, seed=seed)
    ours = bf.BundlefusionDataset(split, bf_root, **kw)
    theirs = jbf.BundlefusionDataset(split, bf_root, **kw)
    assert len(ours) == len(theirs) == {"val": 3, "train": 21}[split]
    for s, t in zip(ours.scans, theirs.scans):
        assert (s["sequence"], s["rel_frame_ids"]) == (t["sequence"], t["rel_frame_ids"])
        assert s["frame_id"] == s["rel_frame_ids"][2]
    order = list(range(len(ours))) + [2, 0, 1]
    for i in order:
        got, want = ours[i], theirs[i]
        assert_items_equal(got, want)
        assert got["frame_id"] == ours.scans[i]["frame_id"]
        assert len(got["img_sources"]) == min(n_sources, 4)
    if n_sources == 1000:
        rel = ours.scans[0]["rel_frame_ids"]
        item = ours[0]
        assert item["source_frame_ids"] == [rel[0], rel[1], rel[3], rel[4]]
        pose = lambda fid: bf.read_pose(os.path.join(bf_root, "copyroom",  # noqa: E731
                                                     f"frame-{fid}.pose.txt"))
        np.testing.assert_array_equal(item["T_source2targets"][0], (
            np.linalg.inv(pose(rel[-1])) @ pose(rel[0])).astype(np.float32))
        np.testing.assert_array_equal(item["img_targets"][0], bf.read_rgb(
            os.path.join(bf_root, "copyroom", f"frame-{rel[-1]}.color.jpg")))


def test_to_model_batch_equal_jax(bf_root):
    """Three source slots for two sources (one padded); 32 GT pixels, and
    more than the image holds; a source with a zeroed depth region and one
    with no depth. A second call draws the same pixels."""
    kw = dict(n_sources=2, frame_interval=1, n_frames=4, seed=5)
    ours = bf.BundlefusionDataset("train", bf_root, **kw)
    theirs = jbf.BundlefusionDataset("train", bf_root, **kw)
    items, jitems = [ours[0], ours[7]], [theirs[0], theirs[7]]
    for its in (items, jitems):
        its[0]["source_depths"][1] = its[0]["source_depths"][1].copy()
        its[0]["source_depths"][1][:20] = 0.0
        its[1]["source_depths"][0] = np.zeros_like(its[1]["source_depths"][0])
    for G in (32, 5000):
        got = bf.to_model_batch(items, C.tiny(n_sources=3, n_gt_depth=G))
        want = jbf.to_model_batch(jitems, JC.tiny(n_sources=3, n_gt_depth=G))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        again = bf.to_model_batch(items, C.tiny(n_sources=3, n_gt_depth=G))
        np.testing.assert_array_equal(again["gt_pix"], got["gt_pix"])
        assert (got["source_mask"] == [[1, 1, 0], [1, 1, 0]]).all()
        rows = got["gt_mask"][0, 1] > 0
        assert got["gt_mask"][1, 0].sum() == 0 and (got["gt_pix"][0, 1, rows, 1] >= 20).all()
        assert rows.sum() == min(G, SIZE[0] * (SIZE[1] - 20))
        assert got["gt_mask"][0, 0].sum() == min(G, SIZE[0] * SIZE[1])


def test_sweep_poses_and_angles_equal_jax():
    for kw in ({}, {"angle": 30.0}, {"angle": 30.0, "step": 1.0, "max_distance": 2.1}):
        got, want = geo.sample_rel_poses_bf(**kw), jgeo.sample_rel_poses_bf(**kw)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    assert [a for _, a in geo.sample_rel_poses_bf(angle=30.0)][:3] == [0.0, -30.0, 30.0]
    for K, (W, H) in ((np.array([[707.0912, 0, 601.8873], [0, 707.0912, 183.1104], [0, 0, 1]]),
                       (1220, 370)),
                      (np.array([[525.0, 0, 320], [0, 525, 240], [0, 0, 1]]), (640, 480)),
                      (np.array([[52.5, 0, 32], [0, 52.5, 24], [0, 0, 1]]), SIZE)):
        assert geo.determine_angles(np.linalg.inv(K), W, H) == \
            jgeo.determine_angles(np.linalg.inv(K), W, H)
    args = ["--img_w", "640", "--img_h", "480", "--fx", "525", "--fy", "525", "--cx", "320",
            "--cy", "240"]
    got = CliRunner().invoke(rcli.cli, ["determine-angles", *args])
    want = CliRunner().invoke(jrecon.determine_angles, args)
    assert got.exit_code == want.exit_code == 0 and got.output == want.output


def _noisy_sphere(shape=(20, 18, 16), seed=0):
    rng = np.random.default_rng(seed)
    x, y, z = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    vol = np.sqrt((x - 9.3) ** 2 + (y - 8.1) ** 2 + (z - 7.7) ** 2) - 5.2
    vol = (vol + rng.normal(0, 0.3, shape)).astype(np.float32)
    vol[:3] = 255.0  # never observed
    return vol


@pytest.mark.parametrize("method", ["mc", "tetra"])
def test_marching_cubes_bit_equal_jax(method):
    for vol in (_noisy_sphere(), _noisy_sphere(seed=1) * 0.01, np.ones((4, 5, 6), np.float32)):
        got = meshing.marching_cubes(vol, method=method)
        want = jmesh.marching_cubes(vol, method=method)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 0 and len(meshing.marching_cubes(_noisy_sphere(), method=method)[1])
    with pytest.raises(ValueError, match="method"):
        meshing.marching_cubes(vol, method="lewiner")


def test_tsdf_volume_mesh_and_point_cloud_equal_jax(tmp_path):
    """The same volumes in both TSDFVolume classes: get_mesh (with and
    without a mask) and get_point_cloud bit-equal; the PLY writers' files
    equal."""
    bnds = np.array([[-0.4, 0.4], [-0.36, 0.36], [0.0, 0.64]])
    vol = tsdf.TSDFVolume(bnds, voxel_size=0.04, device="cpu")
    jvol = jtsdf.TSDFVolume(bnds, voxel_size=0.04)
    assert vol.shape == jvol._tsdf.shape == (20, 18, 16)
    rng = np.random.default_rng(1)
    grid = _noisy_sphere() * 0.04
    color = jtsdf.pack_colors(np.floor(rng.uniform(0, 256, (20, 18, 16, 3)))).astype(np.float32)
    vol.tsdf.copy_(torch.from_numpy(grid))
    vol.color.copy_(torch.from_numpy(color))
    jvol._tsdf, jvol._color = grid, color
    mask = rng.uniform(size=grid.shape) > 0.2
    for got, want in ((vol.get_mesh(), jvol.get_mesh()),
                      (vol.get_mesh(mask), jvol.get_mesh(mask)),
                      (vol.get_point_cloud(), jvol.get_point_cloud())):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert torch.equal(vol.tsdf, torch.from_numpy(grid))  # the mask left the volume alone
    verts, faces, norms, colors = vol.get_mesh()
    meshing.meshwrite(str(tmp_path / "a.ply"), verts, faces, norms, colors)
    jmesh.meshwrite(str(tmp_path / "b.ply"), verts, faces, norms, colors)
    xyzrgb = np.concatenate([verts, colors], axis=1)
    meshing.pcwrite(str(tmp_path / "c.ply"), xyzrgb)
    jmesh.pcwrite(str(tmp_path / "d.ply"), xyzrgb)
    for a, b in (("a", "b"), ("c", "d")):
        assert (tmp_path / f"{a}.ply").read_text() == (tmp_path / f"{b}.ply").read_text()


def _pickles(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_generate_sc_gt_and_eval_sc_match_jax(bf_root, tmp_path):
    """generate-sc-gt-bf of both packages (the port's on the CPU: kernel T's
    plain version), then eval-sc-bf of both on the same predictions."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    res = CliRunner().invoke(rcli.cli, ["generate-sc-gt-bf", "--root", bf_root,
                                        "--recon_save_dir", ours, *WINDOW, "--device", "cpu"],
                             catch_exceptions=False, standalone_mode=False)
    assert res.exit_code == 0, res.output
    assert res.return_value["frames"] == ["000002", "000004", "000006"]
    res = CliRunner().invoke(jrecon.generate_sc_gt_bf, ["--root", bf_root, "--recon_save_dir",
                                                       theirs, *WINDOW])
    assert res.exit_code == 0, res.output
    got, want = (_pickles(os.path.join(d, "sc_gt", "copyroom")) for d in (ours, theirs))
    assert list(got) == list(want) == ["000002.pkl", "000004.pkl", "000006.pkl"]
    ds = ecli.bf_val_ds(bf_root, 1, 4)
    for i, name in enumerate(want):
        g, w = got[name], want[name]
        assert g.keys() == w.keys() == {"tsdf_grid", "occ"}
        assert g["tsdf_grid"].shape == (120, 120, 96) and g["occ"].dtype == np.uint8
        item = ds[i]
        w2c = np.stack([np.linalg.inv(T) for T in item["T_source2infers"]]).astype(np.float32)
        Ks = np.tile(item["cam_K_depth"][None], (len(w2c), 1, 1))
        near = pixel_ties((120, 120, 96), recon.BF_VOX_ORIGIN.astype(np.float32), 0.04,
                          torch.from_numpy(Ks), torch.from_numpy(w2c), tol=TIE_PX).numpy()
        differs = g["tsdf_grid"] != w["tsdf_grid"]
        assert not (differs & ~near).any() and differs.mean() <= MAX_TIE_SHARE, differs.mean()
        np.testing.assert_array_equal(g["occ"][~differs], w["occ"][~differs])
        assert (g["occ"] == 1).any() and (g["occ"] == 0).any()
    # a second run writes nothing
    res = CliRunner().invoke(rcli.cli, ["generate-sc-gt-bf", "--root", bf_root,
                                        "--recon_save_dir", ours, *WINDOW, "--device", "cpu"],
                             standalone_mode=False)
    assert res.return_value["frames"] == []

    # predictions: the GT grids, perturbed
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(ours, "tsdf", "copyroom"))
    for name, g in got.items():
        pred = g["tsdf_grid"] + rng.normal(0, 0.03, g["tsdf_grid"].shape).astype(np.float32)
        with open(os.path.join(ours, "tsdf", "copyroom", name), "wb") as f:
            pickle.dump({"tsdf_grid": pred}, f)
    res = CliRunner().invoke(ecli.cli, ["eval-sc-bf", "--root", bf_root, "--recon_save_dir",
                                        ours, *WINDOW], standalone_mode=False)
    assert res.exit_code == 0, res.output
    jres = CliRunner().invoke(jeval.eval_sc_bf, ["--root", bf_root, "--recon_save_dir", ours,
                                                 *WINDOW], standalone_mode=False)
    assert jres.exit_code == 0, jres.output
    got_s, want_s = res.return_value, jres.return_value
    assert got_s.keys() == want_s.keys() and 0 < got_s["iou"] < 1
    for k in want_s:
        np.testing.assert_array_equal(got_s[k], want_s[k], err_msg=k)
    assert res.output == jres.output


def test_depth_visual_matches_matplotlib(tmp_path):
    rng = np.random.default_rng(3)
    nan = rng.uniform(0.5, 5, (30, 40)).astype(np.float32)
    nan[3, 4] = np.nan
    for i, depth in enumerate([rng.uniform(0.05, 120, (48, 64)).astype(np.float32),
                               rng.uniform(0.5, 5, (480, 640)).astype(np.float32),
                               rng.uniform(0.5, 5, (30, 40)), np.full((10, 12), 3.0, np.float32),
                               nan]):
        common.save_depth_visual(str(tmp_path / f"p{i}.png"), depth)
        jcommon.save_depth_visual(str(tmp_path / f"j{i}.png"), depth)
        got, want = (np.array(Image.open(tmp_path / f"{s}{i}.png")) for s in "pj")
        assert got.shape == want.shape == (*depth.shape, 3)
        np.testing.assert_array_equal(got, want)
