"""The port's KITTI evaluation commands against the JAX package's
(`scenerf_tpu/cli/evaluation.py`), on the CPU at the `tiny` size:

- the host pieces are exactly equal to JAX's on seeded inputs: the depth
  errors' 7-vector, the strided pixel grid, both printed tables, PSNR, SSIM,
  and every item of the eval val reader (all sources, every LiDAR return,
  ICP computed by each package into its own preprocess tree);
- LPIPS: JAX's random weights through its npz into the port within rtol
  1e-4 on three 64x96 pairs; the same weights in torchvision's and lpips'
  layouts load into the same module; identical images score 0;
- `render_depth_at_pixels` with JAX's weights, the same sphere maps and
  JAX's noise (drawn over the padded rays, its first rows kept) within rtol
  1e-3 of JAX's jitted renderer, the render tolerance of
  test_torch_train_cli.py; the depth errors within rtol 1e-3;
- the CLI chain with `--device cpu` on a fake KITTI tree and a `tiny`
  checkpoint: save-depth-metrics, agg-depth-metrics, render-colors and
  eval-color write JAX's file names and layout, skip on a second run, and
  JAX's `_agg_depth_metrics_impl` / `_eval_color_impl` read the port's
  files and give its numbers (LPIPS within rtol 1e-4).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from _torch_kitti_tree import write_kitti_tree
from _torch_parity import jax_variables, port_model
from scenerf_tpu import config as JC
from scenerf_tpu import sampling as JS
from scenerf_tpu.cli import common as jcommon
from scenerf_tpu.cli import evaluation as jeval
from scenerf_tpu.data.kitti import VAL_ERROR_FRAMES as JAX_VAL_ERROR_FRAMES
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.utils import image_metrics as jim
from scenerf_tpu.utils.lpips import LPIPS as JaxLPIPS
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.cli import evaluation as E
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.utils import image_metrics as im
from scenerf_tpu_torch.utils.checkpoint import save_checkpoint
from scenerf_tpu_torch.utils.lpips import LPIPS

torch.set_num_threads(1)
JCFG = dict(remat_chunks=False, remat_encoder=False)
SEQ_DIST = "1.1"  # the CLI chain's scans: 2 + 1 sources at 0.5-1.1 m


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Val sequence 08 of 12 frames: val items 000005 (6 sources) and
    000010 (1 source)."""
    return write_kitti_tree(str(tmp_path_factory.mktemp("kitti")), {"08": 12})


# --------------------------------------------------------------- host pieces


def test_depth_errors_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 7, 4000):
        gt = rng.uniform(0.5, 80.0, n).astype(np.float32)
        pred = (gt * rng.uniform(0.5, 1.6, n)).astype(np.float32)
        pred[: n // 7] = rng.uniform(-1.0, 120.0, n // 7)  # clipped at both ends
        for max_depth in (80.0, 10.0):
            got = E.compute_depth_errors_np(gt, pred, max_depth=max_depth)
            want = jeval.compute_depth_errors_np(gt, pred, max_depth=max_depth)
            assert got.dtype == want.dtype and got.shape == (7,)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("img_size,stride", [((1220, 370), 3), ((640, 480), 2), ((64, 48), 5)])
def test_strided_pixel_grid_matches_jax(img_size, stride):
    got, got_shape = common.strided_pixel_grid(img_size, stride)
    want, want_shape = jcommon.strided_pixel_grid(img_size, stride)
    assert got_shape == want_shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tables_match_jax(capsys):
    rng = np.random.default_rng(1)
    agg = {int(k): rng.uniform(0, 5, 7) for k in (3, 1, 12)}
    n_frames = {k: int(rng.integers(1, 40)) for k in agg}
    sums = [{k: float(rng.uniform(0, 90)) for k in agg} for _ in range(3)]
    cnt = {k: int(rng.integers(1, 9)) for k in agg}
    outs = []
    for mod in (common, jcommon):
        mod.print_depth_metrics_table(agg, n_frames)
        mod.print_depth_metrics_table({}, {})
        for enabled in (True, False):
            mod.print_color_metrics_table(*sums, cnt, lpips_enabled=enabled)
        mod.print_color_metrics_table({}, {}, {}, {})
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "All     " in outs[0] and "skipped " in outs[0]


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(2)
    for shape in ((124, 407, 3), (30, 41), (9, 9, 3)):
        a = rng.uniform(0, 1, shape).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        assert im.psnr(a, b) == jim.psnr(a, b)
        assert im.ssim(a, b) == jim.ssim(a, b)
        assert im.ssim(a, a) == 1.0


def test_eval_val_ds_matches_jax(tree, tmp_path):
    """Every source of each scan in order, every LiDAR return: equal items
    (each package computing its own ICP)."""
    ours = common.eval_val_ds(tree, str(tmp_path / "port"), 10.0, 0.4)
    theirs = jeval._kitti_val_ds(tree, str(tmp_path / "jax"), 10.0, 0.4)
    assert [s["frame_id"] for s in ours.scans] == [s["frame_id"] for s in theirs.scans] == [
        "000005", "000010"]
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, list):
                assert len(got[k]) == len(w), k
                for a, b in zip(got[k], w):
                    np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert len(got["source_frame_ids"]) == {0: 6, 1: 1}[i]
        assert all(len(d) > 1000 for d in got["lidar_depths"])


# -------------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    JaxLPIPS.random_init(jax.random.PRNGKey(3)).to_npz(path)
    return path


def test_lpips_matches_jax(lpips_npz, tmp_path):
    ours, theirs = LPIPS.from_npz(lpips_npz), JaxLPIPS.from_npz(lpips_npz)
    rng = np.random.default_rng(4)
    for _ in range(3):
        a = rng.uniform(-1, 1, (64, 96, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
        got = float(ours(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(theirs(jnp.asarray(a), jnp.asarray(b)))
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(ours(torch.from_numpy(a), torch.from_numpy(a))) == 0.0
    # the same weights in torchvision's and lpips' layouts
    sd = ours.state_dicts()
    torch.save(sd["vgg"], tmp_path / "vgg16.pth")
    torch.save({k.replace("lin", "lins."): v for k, v in sd["lpips"].items()},
               tmp_path / "lpips_vgg.pth")
    again = LPIPS.from_torch_checkpoint(str(tmp_path / "vgg16.pth"),
                                        str(tmp_path / "lpips_vgg.pth"))
    want_sd = ours.state_dict()
    assert again.state_dict().keys() == want_sd.keys()
    for k, v in again.state_dict().items():
        assert torch.equal(v, want_sd[k]), k


# ------------------------------------------------------------------- render

CHUNK, N_PIX = 128, 300  # the port's last chunk ragged (44 rays); JAX pads to 384


def test_render_depth_at_pixels_matches_jax():
    jcfg, cfg = JC.tiny(**JCFG), C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=5)
    model = port_model(cfg, variables)
    K = default_intrinsics(cfg)
    img = input_frame(cfg, seed=6)
    maps = model.compute_sphere_maps(K)  # numpy, for both packages
    rng = np.random.default_rng(7)
    W, H = cfg.img_size
    pixels = np.stack([rng.integers(0, W, N_PIX), rng.integers(0, H, N_PIX)], -1).astype(
        np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.2, -0.05, 0.4)
    key = jax.random.PRNGKey(8)

    levels, _ = jax.jit(lambda v, x, k_, mp: jm.encode(v, x, k_, sphere_maps=mp))(
        variables, jnp.asarray(img), jnp.asarray(K), maps)
    render_fn = jeval.make_ray_renderer(jm, CHUNK, devices=jax.devices()[:1])
    want_d, want_c = jeval.render_depth_at_pixels(render_fn, variables,
                                                  jeval._item_levels(levels), K, T, pixels,
                                                  CHUNK, key)
    # JAX's noise, drawn as its render draws it: over the padded rays
    n_pad = -(-N_PIX // CHUNK) * CHUNK
    k_uni, k_gauss = jax.random.split(key)
    nu = np.array(JS.row_noise(k_uni, n_pad, cfg.n_pts_uni))[:N_PIX]
    ng = np.array(JS.row_noise(k_gauss, n_pad, cfg.n_pts_gauss, dist="normal"))[:N_PIX]
    pyramid = model.pyramid_for_item(model.encode(torch.from_numpy(img), K, sphere_maps=maps), 0)
    got_d, got_c = E.render_depth_at_pixels(model, pyramid, K, T, pixels, CHUNK, None,
                                            noise_uni=torch.from_numpy(nu),
                                            noise_gauss=torch.from_numpy(ng))
    assert got_d.shape == want_d.shape == (N_PIX,) and got_c.shape == want_c.shape == (N_PIX, 3)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-3)
    gt = (want_d * rng.uniform(0.6, 1.5, N_PIX)).astype(np.float32)
    np.testing.assert_allclose(E.compute_depth_errors_np(gt, got_d),
                               jeval.compute_depth_errors_np(gt, want_d), rtol=1e-3)
    # in train mode it refuses
    with pytest.raises(ValueError, match="eval mode"):
        E.render_depth_at_pixels(model.train(), pyramid, K, T, pixels, CHUNK, None)


# ---------------------------------------------------------------- CLI chain


def _invoke(args):
    res = CliRunner().invoke(E.cli, args, catch_exceptions=False, standalone_mode=False)
    assert res.exit_code == 0, res.output
    return res.return_value, res.output


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_chain_on_cpu(tree, tmp_path, lpips_npz, capsys):
    cfg = C.tiny(img_size=(1220, 370))
    torch.manual_seed(9)
    save_checkpoint(str(tmp_path / "model.pt"), SceneRF(cfg))
    out = str(tmp_path / "eval")
    kitti = ["--root", tree, "--preprocess_root", str(tmp_path / "pre"), "--model_path",
             str(tmp_path / "model.pt"), "--eval_save_dir", out, "--sequence_distance", SEQ_DIST]

    # the names JAX's commands give, from its own reader
    jitems = [it for it in (jeval._kitti_val_ds(tree, str(tmp_path / "jpre"), float(SEQ_DIST),
                                                0.4)[i] for i in range(2))]
    names = [f"{it['frame_id']}_{it['source_frame_ids'][s]}_{it['source_distances'][s]:.2f}.png"
             for it in jitems for s in range(len(it["source_frame_ids"]))]
    assert len(names) == 3

    done, _ = _invoke(["save-depth-metrics", *kitti, "--device", "cpu"])
    assert done["frames"] == ["000005", "000010"] and list(map(len, done["rays"])) == [2, 1]
    assert _files(out) == ["depth_metrics/08/000005.npy", "depth_metrics/08/000010.npy"]
    for f in _files(out):
        with open(os.path.join(out, f), "rb") as fh:
            data = pickle.load(fh)
        assert data.keys() == {"depth_errors", "n_frames"}
        assert all(np.isfinite(v).all() and v.shape == (7,) for v in data["depth_errors"].values())

    port_agg = _invoke(["agg-depth-metrics", "--eval_save_dir", out])[0]
    capsys.readouterr()
    E._agg_depth_metrics_impl(out, ["08"])
    port_out = capsys.readouterr().out
    jax_agg = jeval._agg_depth_metrics_impl(out, ["08"])
    assert capsys.readouterr().out == port_out and "====== Total ======" in port_out
    for got, want in zip(port_agg, jax_agg):
        assert got.keys() == want.keys() and sum(port_agg[1].values()) == 3
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    done, _ = _invoke(["render-colors", *kitti, "--device", "cpu"])
    assert done["images"] == 3
    assert _files(out) == sorted(["depth_metrics/08/000005.npy", "depth_metrics/08/000010.npy"]
                                 + [f"{d}/08/{n}" for d in ("rgb", "render_rgb") for n in names])
    for n in names:
        assert Image.open(os.path.join(out, "render_rgb", "08", n)).size == (407, 124)
        src = os.path.join(tree, "dataset", "sequences", "08", "image_2", n.split("_")[1] + ".png")
        with open(src, "rb") as a, open(os.path.join(out, "rgb", "08", n), "rb") as b:
            assert a.read() == b.read()

    # a second run renders nothing and writes nothing
    stamps = {f: os.stat(os.path.join(out, f)).st_mtime_ns for f in _files(out)}
    assert _invoke(["save-depth-metrics", *kitti, "--device", "cpu"])[0]["frames"] == []
    assert _invoke(["render-colors", *kitti, "--device", "cpu"])[0]["images"] == 0
    assert {f: os.stat(os.path.join(out, f)).st_mtime_ns for f in _files(out)} == stamps

    # eval-color with the npz's weights in torchvision's and lpips' layouts
    sd = LPIPS.from_npz(lpips_npz).state_dicts()
    torch.save(sd["vgg"], tmp_path / "vgg16.pth")
    torch.save(sd["lpips"], tmp_path / "lpips_vgg.pth")
    got, _ = _invoke(["eval-color", "--eval_save_dir", out, "--lpips_vgg_path",
                      str(tmp_path / "vgg16.pth"), "--lpips_lin_path",
                      str(tmp_path / "lpips_vgg.pth"), "--device", "cpu"])
    want = jeval._eval_color_impl(out, "08", (407, 124), skip_frames=JAX_VAL_ERROR_FRAMES,
                                  lpips_weights=lpips_npz)
    assert sum(got["count"].values()) == 3 and len(got["lpips_s"]) == 3
    for key, w in zip(("psnr", "ssim", "lpips", "count"), want):
        assert got[key].keys() == w.keys(), key
        for k in w:
            if key == "lpips":
                np.testing.assert_allclose(got[key][k], w[k], rtol=1e-4)
            else:
                assert got[key][k] == w[k], key
    # without weights: the LPIPS column is skipped, as JAX prints it
    capsys.readouterr()
    E._eval_color_impl(out, "08", (407, 124), skip_frames=E.VAL_ERROR_FRAMES)
    port_out = capsys.readouterr().out.splitlines()[1:]
    jeval._eval_color_impl(out, "08", (407, 124), skip_frames=JAX_VAL_ERROR_FRAMES)
    assert capsys.readouterr().out.splitlines()[1:] == port_out
    assert "skipped " in port_out[-1]


def test_cli_flags_and_help():
    res = CliRunner().invoke(E.cli, ["--help"])
    for name in ("eval-sr", "save-depth-metrics", "agg-depth-metrics", "render-colors",
                 "eval-color"):
        assert name in res.output
    for cmd in ("save-depth-metrics", "render-colors"):
        # outside a two-rank world (no torchrun here: one rank) it refuses
        res = CliRunner().invoke(E.cli, [cmd, "--n_devices", "2", "--device", "cpu"])
        assert res.exit_code == 2 and "--n_devices 2" in res.output
        assert "the world has 1 rank" in res.output
    if not torch.cuda.is_available():  # the default device is the card's
        res = CliRunner().invoke(E.cli, ["save-depth-metrics"])
        assert res.exit_code == 2 and "no CUDA device" in res.output
