"""The reconstruction slice of the PyTorch port against the JAX package, on
the CPU (the port on its plain versions): TSDF integration (kernel T's plain
version) against `_integrate_frames` / `TSDFVolume`, the upsample against
`jax.image.resize`, the occupancy thresholds, color packing, SSC metrics,
voxel IO and the KITTI val reader; then the CLI chain generate-novel-depths
-> depth2tsdf -> eval-sr on a fake KITTI val tree.

Tolerances: the TSDF volumes must be equal, except on voxels where some
frame projects within 1e-4 px of a .5 rounding boundary (there a 1-ulp
difference picks another pixel); such voxels may differ on at most 0.1% of
the grid. The upsample: rtol 1e-6 (and 1e-6 x max|img| absolute). Everything
else: exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from scenerf_tpu.data import calib as jcalib
from scenerf_tpu.data import io_voxel as jio
from scenerf_tpu.data.kitti import KittiDataset as JaxKitti
from scenerf_tpu.fusion import tsdf as jtsdf
from scenerf_tpu.utils.ssc_metrics import SSCMetrics as JaxSSCMetrics
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import evaluation as ecli
from scenerf_tpu_torch.cli import reconstruction as rcli
from scenerf_tpu_torch.data import calib, io_voxel
from scenerf_tpu_torch.data.kitti import KittiDataset
from scenerf_tpu_torch.data.synthetic import KITTI_P2, KITTI_TR
from scenerf_tpu_torch.fusion import tsdf
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops.tsdf import integrate, pixel_ties
from scenerf_tpu_torch.utils.checkpoint import save_checkpoint
from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

torch.set_num_threads(1)

TIE_PX = 1e-4
MAX_TIE_SHARE = 1e-3
RESIZE_RTOL = 1e-6


def assert_volumes_match(got, want, near):
    """Equal, except near-tie voxels (<= MAX_TIE_SHARE of the grid)."""
    differs = np.zeros(near.shape, bool)
    for g, w in zip(got, want):
        differs |= np.asarray(g) != np.asarray(w)
    assert not (differs & ~near).any(), int((differs & ~near).sum())
    assert differs.mean() <= MAX_TIE_SHARE, differs.mean()


def _pose(i):
    a = 0.15 * i - 0.3
    c, s = np.cos(a), np.sin(a)
    P = np.eye(4)
    P[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    P[:3, 3] = [0.4 * i - 1.0, 0.1 * i, -1.5 + 0.5 * i]
    return P


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_integrate_frames_matches_jax(mode):
    """40x40x12 grid, 5 frames in sweep order, zero-depth rows and voxels
    behind some cameras; "average" from a partly filled volume."""
    rng = np.random.default_rng(3)
    shape, F_, H, W = (40, 40, 12), 5, 30, 50
    K = np.array([[40, 0, 25.3], [0, 40, 14.7], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (F_, 1, 1))
    w2c = np.stack([np.linalg.inv(_pose(i)) for i in range(F_)]).astype(np.float32)
    depths = rng.uniform(0.5, 8.0, (F_, H, W)).astype(np.float32)
    depths[:, :3] = 0.0
    packed = jtsdf.pack_colors(np.floor(rng.uniform(0, 256, (F_, H, W, 3)))).astype(np.float32)
    origin = np.array([-4.0, -3.0, 0.2], np.float32)
    if mode == "closest":
        init = [np.full(shape, 255.0, np.float32), np.zeros(shape, np.float32),
                np.zeros(shape, np.float32)]
    else:
        init = [rng.uniform(-1, 1, shape).astype(np.float32),
                rng.integers(0, 3, shape).astype(np.float32),
                jtsdf.pack_colors(np.floor(rng.uniform(0, 256, (*shape, 3)))).astype(np.float32)]
    want = jtsdf._integrate_frames(*init, depths, packed, Ks, w2c, origin, 0.2, 0.7, 1.0,
                                   mode=mode)
    got = [torch.from_numpy(a.copy()) for a in init]
    integrate(*got, *(torch.from_numpy(a) for a in (depths, packed, Ks, w2c)), origin, 0.2,
              0.7, 1.0, mode)
    assert (np.asarray(want[1]) > init[1]).any()  # frames were integrated
    near = pixel_ties(shape, origin, 0.2, torch.from_numpy(Ks), torch.from_numpy(w2c),
                      tol=TIE_PX).numpy()
    assert_volumes_match([g.numpy() for g in got], want, near)


def _wall(depth, W=64, H=48, f=50.0):
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    color = np.zeros((H, W, 3), np.float32)
    color[..., 0] = 200.0
    return K, np.full((H, W), depth, np.float32), color


@pytest.mark.parametrize("case", ["wall", "closest_tie"])
def test_tsdf_volume_matches_jax(case):
    """tests/test_fusion.py's cases through both TSDFVolume classes: one wall
    frame; two walls (2.0 m, then 2.5 m) integrated one by one in JAX and as
    one stack in the port. The grid-aligned walls put many projections on
    exact .5 boundaries: both round them half to even."""
    if case == "wall":
        bnds, frames = [[-1.0, 1.0], [-1.0, 1.0], [0.5, 3.5]], [_wall(2.0)]
    else:
        bnds, frames = [[-0.5, 0.5], [-0.5, 0.5], [1.0, 3.0]], [_wall(2.0), _wall(2.5)]
    jvol = jtsdf.TSDFVolume(np.array(bnds), voxel_size=0.1, trunc_margin=10.0)
    for K, depth, color in frames:
        jvol.integrate(color, depth, K, np.eye(4))
    vol = tsdf.TSDFVolume(np.array(bnds), voxel_size=0.1, trunc_margin=10.0, device="cpu")
    vol.integrate_frames(np.stack([c for _, _, c in frames]), np.stack([d for _, d, _ in frames]),
                         np.stack([K for K, _, _ in frames]), np.stack([np.eye(4)] * len(frames)))
    assert vol.shape == jvol._tsdf.shape
    np.testing.assert_array_equal(vol._vol_origin, jvol._vol_origin)
    for got, want in zip((*vol.get_volume(), vol.weight.numpy()),
                         (*jvol.get_volume(), np.asarray(jvol._weight))):
        np.testing.assert_array_equal(got, want)


def test_kitti_grid_dims():
    """256 x 256 x 32 from the float64 bounds, sentinel 255."""
    vol = recon.kitti_volume("cpu")
    assert vol.shape == (256, 256, 32)
    assert bool((vol.tsdf == 255).all()) and not bool(vol.weight.any())


@pytest.mark.parametrize("shape,out_hw", [((12, 16), (24, 32)), ((12, 16, 3), (24, 32)),
                                          ((47, 153), (370, 1220))])
def test_upsample_to_matches_jax_resize(shape, out_hw):
    """Exact 2x (depth and color: the border pixels are the input's, where
    torch blends the last pixel with itself, 0.75 a + 0.25 a, within one
    rounding) and the CLI test's stride-8 grid to 1220x370 (ratios 7.97 and
    7.87)."""
    img = np.random.default_rng(1).uniform(0.0, 80.0, shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*out_hw, *shape[2:]),
                                       method="bilinear"))
    got = recon.upsample_to(torch.from_numpy(img), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RESIZE_RTOL,
                               atol=RESIZE_RTOL * np.abs(want).max())
    if out_hw[0] == 2 * shape[0]:
        for corner in ((0, 0), (-1, -1), (0, -1), (-1, 0)):
            np.testing.assert_allclose(got[corner], img[corner], rtol=RESIZE_RTOL, atol=0)


def test_host_numpy_functions_exact():
    """tsdf2occ, tsdf2occ_bf, tsdf_to_gt_occupancy, pack/unpack, SSCMetrics."""
    rng = np.random.default_rng(2)
    vol = rng.uniform(-2, 2, (60, 20, 24)).astype(np.float32)
    vol[rng.random(vol.shape) < 0.3] = 255.0
    np.testing.assert_array_equal(tsdf.tsdf2occ(vol, 0.25, 6.0), jtsdf.tsdf2occ(vol, 0.25, 6.0))
    np.testing.assert_array_equal(tsdf.tsdf2occ_bf(vol, 0.05), jtsdf.tsdf2occ_bf(vol, 0.05))
    np.testing.assert_array_equal(tsdf.tsdf_to_gt_occupancy(vol, 0.04),
                                  jtsdf.tsdf_to_gt_occupancy(vol, 0.04))
    rgb = np.floor(rng.uniform(0, 256, (7, 9, 3))).astype(np.float32)
    packed = tsdf.pack_colors(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(packed, jtsdf.pack_colors(rgb))
    np.testing.assert_array_equal(tsdf.unpack_colors(packed), jtsdf.unpack_colors(packed))

    ours, theirs = SSCMetrics(3), JaxSSCMetrics(3)
    for _ in range(2):
        pred = rng.integers(0, 3, (1, 20, 20, 8))
        target = rng.integers(0, 3, (1, 20, 20, 8)).astype(np.float32)
        target[rng.random(target.shape) < 0.1] = 255
        mask = rng.random(target.shape) < 0.8
        ours.add_batch(pred, target, mask)
        theirs.add_batch(pred, target, mask)
    a, b = ours.get_stats(), theirs.get_stats()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------- a fake KITTI val tree
N_FRAMES = 11  # anchors 000000 (corrupt-GT list), 000005, 000010 (no successor)


def write_fake_kitti_val(root):
    """Sequence 08: calib.txt (KITTI P2 / Tr), forward poses 0.5 m apart,
    smooth 1241x376 PNGs, and voxel GT (a road slab, a block, some invalid
    voxels) on every 5th frame. scripts/make_fake_kitti.py --val raytraces a
    textured world (about a second per frame); the reader and the CLI need
    only the layout."""
    from PIL import Image

    seq = os.path.join(root, "dataset", "sequences", "08")
    for d in ("image_2", "voxels"):
        os.makedirs(os.path.join(seq, d), exist_ok=True)
    os.makedirs(os.path.join(root, "dataset", "poses"), exist_ok=True)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        f.write("P2: " + " ".join(str(v) for v in KITTI_P2.reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(str(v) for v in KITTI_TR.reshape(-1)) + "\n")
    yy, xx = np.mgrid[0:376, 0:1241]
    lines = []
    for i in range(N_FRAMES):
        T = np.eye(4)
        T[:3, 3] = [0.3 * np.sin(0.5 * i), 0.0, 0.5 * i]
        lines.append(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)))
        img = np.stack([xx * 0.2 + 10 * i, yy * 0.6, (xx + yy) * 0.1], -1) % 256
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(seq, "image_2", f"{i:06d}.png"))
    with open(os.path.join(root, "dataset", "poses", "08.txt"), "w") as f:
        f.write("\n".join(lines))
    labels = np.zeros((256, 256, 32), np.uint16)
    labels[:, :, 1] = 40   # road
    labels[100:140, 120:136, 2:9] = 50   # building
    invalid = np.zeros((256, 256, 32), np.uint8)
    invalid[220:] = 1
    for i in range(0, N_FRAMES, 5):
        labels.tofile(os.path.join(seq, "voxels", f"{i:06d}.label"))
        np.packbits(invalid).tofile(os.path.join(seq, "voxels", f"{i:06d}.invalid"))
        np.packbits(labels > 0).tofile(os.path.join(seq, "voxels", f"{i:06d}.bin"))
    return root


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return write_fake_kitti_val(str(tmp_path_factory.mktemp("kitti")))


def test_voxel_io_and_vox2pix_exact(kitti_root):
    vox = os.path.join(kitti_root, "dataset", "sequences", "08", "voxels", "000005")
    got = io_voxel.read_semantic_voxels(vox + ".label", vox + ".invalid")
    np.testing.assert_array_equal(got, jio.read_semantic_voxels(vox + ".label",
                                                                vox + ".invalid"))
    assert set(np.unique(got)) == {0, 9, 13, 255}
    cal = calib.read_calib(os.path.join(kitti_root, "dataset", "sequences", "08", "calib.txt"))
    jcal = jcalib.read_calib(os.path.join(kitti_root, "dataset", "sequences", "08", "calib.txt"))
    E = (cal["T_cam0_2_cam2"] @ cal["Tr"]).astype(np.float32)
    for a, b in zip(calib.vox2pix(E, cal["P2"][:3, :3], np.array([0, -25.6, -2]), 0.2, 1220, 370,
                                  (51.2, 51.2, 6.4)),
                    jcalib.vox2pix(E, jcal["P2"][:3, :3], np.array([0, -25.6, -2]), 0.2, 1220,
                                   370, (51.2, 51.2, 6.4))):
        np.testing.assert_array_equal(a, b)


def test_kitti_val_reader_matches_jax(kitti_root):
    ours = KittiDataset("val", kitti_root, "", n_sources=0, load_voxels=True)
    theirs = JaxKitti("val", kitti_root, "", n_sources=0, load_voxels=True)
    assert [s["frame_id"] for s in ours.scans] == [s["frame_id"] for s in theirs.scans] == ["000005"]
    got, want = ours[0], theirs[0]
    for k in ("frame_id", "sequence", "img_input", "cam_K", "T_velo_2_cam", "target_1_1",
              "fov_mask_1"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    # source frames are ported too: with sources the walk finds the same scans
    # (their items, which read LiDAR, are held in test_torch_kitti_data.py)
    ours, theirs = (D("val", kitti_root, "", n_sources=1) for D in (KittiDataset, JaxKitti))
    assert [s["rel_frame_ids"] for s in ours.scans] == [s["rel_frame_ids"] for s in theirs.scans]


def test_cli_chain_on_cpu(kitti_root, tmp_path):
    """generate-novel-depths (stride 8, 9 poses) -> depth2tsdf -> eval-sr with
    a tiny-width model at the KITTI image size, on the CPU; then the same
    commands again skip every frame whose outputs exist."""
    torch.manual_seed(0)
    cfg = C.tiny(img_size=(1220, 370), n_pts_uni=4, n_gaussians=2, n_pts_per_gaussian=2)
    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, SceneRF(cfg))
    out = str(tmp_path / "recon")
    common = ["--root", kitti_root, "--recon_save_dir", out, "--max_distance", "1.1"]
    gen = ["generate-novel-depths", "--model_path", ckpt, "--scale", "8", "--device", "cpu",
           *common]
    fuse = ["depth2tsdf", "--device", "cpu", *common]
    runner = CliRunner()
    res = runner.invoke(rcli.cli, gen, catch_exceptions=False)
    assert "saved sweep for frame 000005 (9 poses)" in res.output
    names = [f"000005_{s}_{a}" for s in (0.0, 0.5, 1.0) for a in (0.0, 10.0, -10.0)]
    for sub, ext in (("depth", ".npy"), ("render_rgb", ".png"), ("depth_visual", ".png")):
        assert sorted(os.listdir(os.path.join(out, sub, "08"))) == sorted(n + ext for n in names)
    depth = np.load(os.path.join(out, "depth", "08", names[0] + ".npy"))
    assert depth.shape == (370, 1220) and np.isfinite(depth).all()

    res = runner.invoke(rcli.cli, fuse, catch_exceptions=False)
    tsdf_path = os.path.join(out, "tsdf", "08", "000005.npy")
    assert f"saved to {tsdf_path}" in res.output
    vol = np.load(tsdf_path)
    assert vol.shape == (256, 256, 32) and vol.dtype == np.float32
    assert (vol != 255).any() and np.isfinite(vol).all()

    res = runner.invoke(ecli.cli, ["eval-sr", "--root", kitti_root, "--recon_save_dir", out],
                        catch_exceptions=False)
    lines = res.output.splitlines()
    assert lines[0] == "==== Whole Scene ====" and lines[2] == "==== in FOV ===="
    for line in (lines[1], lines[3]):
        vals = [float(v) for v in line.split()]
        assert len(vals) == 3 and all(np.isfinite(v) and 0 <= v <= 1 for v in vals)

    stamps = {p: os.path.getmtime(p) for p in (tsdf_path, os.path.join(
        out, "depth", "08", names[0] + ".npy"))}
    assert runner.invoke(rcli.cli, gen, catch_exceptions=False).output == ""
    assert runner.invoke(rcli.cli, fuse, catch_exceptions=False).output == ""
    assert {p: os.path.getmtime(p) for p in stamps} == stamps
