"""The port's BundleFusion training step and entry points against the JAX
package's, on the CPU (the port on its kernels' plain versions), at a
`tiny`-width model with the BundleFusion preset's loss and sampling fields
(`sample_grid_size` 2, `som_sigma` 0.02, `reprojection_weight` 5,
`dist2closest_weight` 0.1, `max_sample_depth` 12, `std` 0.2,
`mean_std_floor` 0.5, the BundleFusion sphere angles) on a fake 64x48 tree
of all 8 scenes (`scripts/make_fake_bf.py`, 10 frames each, windows of 4
frames at interval 1):

- one training step from the same seeded weights on the same BundleFusion
  batch with every draw injected (as tests/test_torch_train_step.py does):
  the loss and metrics rtol 1e-3, every gradient leaf relative L2 <= 1e-2,
  and RaySOM on the step's own render inputs held to JAX's `ray_som`
  (`som_against_jax(tie_ulps=4)`: the rays whose best prototype differs,
  each a rounding tie, and the KL's relative difference, printed);
- `train-bundlefusion`'s flags against the JAX command's config and
  experiment name, and two CPU runs of it, the second resuming;
- a JAX checkpoint with this config converted by
  `scripts/convert_jax_checkpoint_torch.py`: the port's `load_model` renders
  JAX's depth (rtol 1e-3);
- on that checkpoint, `save-depth-metrics-bf` (the port fed JAX's noise rows
  over its padded rays, as tests/test_torch_eval_cli.py feeds them) and
  `render-colors-bf` against the JAX commands: the error 7-vectors rtol 1e-3
  (the threshold shares a1-a3 within one pixel in a thousand), the
  upsampled renders rtol 1e-3, the PNGs within one level; then
  `agg-depth-metrics-bf` and `eval-color-bf` equal to JAX's on the port's
  files (the JAX commands' frame encode jitted, once for both, where they
  run it op by op);
- `generate-novel-depths-bf` -> `depth2tsdf-bf` -> `generate-sc-gt-bf` ->
  `eval-sc-bf` on the CPU: JAX's file names; JAX's depth2tsdf-bf on the
  port's sweep gives the same grid (but for pixel-rounding ties) and the
  port's mesh is JAX's marching cubes of the port's grid, bit for bit;
  eval-sc-bf equal to JAX's; second runs write nothing.
"""
import dataclasses
import importlib.util
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from _torch_kitti_tree import REPO
from _torch_parity import jax_variables, port_model, som_against_jax
from test_torch_train_step import jax_draws
from scenerf_tpu import config as JC
from scenerf_tpu import geometry as jgeo
from scenerf_tpu import sampling as JS
from scenerf_tpu.cli import common as jcommon
from scenerf_tpu.cli import evaluation as jeval
from scenerf_tpu.cli import reconstruction as jrecon
from scenerf_tpu.cli import train as jax_train_cli
from scenerf_tpu.data import bundlefusion as jbf
from scenerf_tpu.fusion import meshing as jmesh
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.parallel.mesh import make_mesh
from scenerf_tpu.train import Trainer as JaxTrainer
from scenerf_tpu.train import TrainState, make_optimizer
from scenerf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.cli import evaluation as E
from scenerf_tpu_torch.cli import reconstruction as RC
from scenerf_tpu_torch.cli import train as train_cli
from scenerf_tpu_torch.data import bundlefusion as bf
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops.tsdf import pixel_ties
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import weights as W
from scenerf_tpu_torch.utils.checkpoint import CheckpointManager, load_model
from scripts.make_fake_bf import write_fake_bf

torch.set_num_threads(1)
JCFG = dict(remat_chunks=False, remat_encoder=False)
SIZE = (64, 48)
WINDOW = ["--frame_interval", "1", "--n_frames", "4"]
# the evaluation commands' window: one val item (frame 4) with 8 sources (JAX's
# commands encode each item op by op, ~5 s a frame on the CPU)
EVAL_WINDOW = ["--frame_interval", "1", "--n_frames", "8"]
GROUPS = ("net_rgb.encoder.", "net_rgb.decoder.", "mlp.", "mlp_gaussian.")
GRAD_REL_L2 = 1e-2
TIE_PX = 1e-4
MAX_TIE_SHARE = 1e-3
# XLA's CPU compile of JAX's TSDF step contracts the camera depth's last
# product and sum, R[2, 2] * z + (...), into an fma at the BundleFusion grid
# (120x120x96; not at KITTI's 256x256x32), where the port rounds each (as
# XLA does at KITTI's grid): away from pixel ties the fused grids differ by
# the rounding of one f32 at the grid's depths, two spacings at 16 m
CZ_ULPS_ATOL = 2 * float(np.spacing(np.float32(16.0)))


# The test sphere. The BundleFusion preset's base angles are symmetric about
# 90 degrees, so on a sphere of even width and height (the preset's 960x720,
# or 80x64) the camera's principal axes map exactly onto .5 cell
# boundaries, and the fake tree's principal point is a pixel centre and its
# poses translate along z only: every sample of a ray in the principal row or
# column rounds to a cell that the last bit of the two libraries' projection
# decides. 81x65 maps the axes onto cell centres instead; the ties at 80x64
# are shown by test_converted_bf_checkpoint_renders_like_jax.
SPHERE_WH = (81, 65)


def bf_tiny(mod, **kw):
    """The BundleFusion preset of `mod` (either package's config module) at
    the `tiny` widths and image size, on the test sphere."""
    sphere = dataclasses.replace(mod.bundlefusion().sphere, width=SPHERE_WH[0],
                                 height=SPHERE_WH[1])
    return mod.bundlefusion(img_size=SIZE, sphere=sphere, n_rays=64, n_pts_uni=8, n_gaussians=3,
                            n_pts_per_gaussian=4, d_hidden=32, n_blocks=2, d_latent=0,
                            encoder="tiny", encoder_features=64, n_sources=2, n_gt_depth=32,
                            ray_chunk=32, eval_ray_chunk=64, **kw)


@pytest.fixture(scope="module")
def bf_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bf"))
    write_fake_bf(root, frames=10, size=SIZE, scenes=tuple(bf.SPLITS["all"]))
    return root


# ------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def step_run(bf_root):
    jcfg, cfg = bf_tiny(JC, **JCFG), bf_tiny(C)
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=11)
    params = {k: variables[k]["params"] for k in variables}
    stats = variables["net_rgb"]["batch_stats"]
    tx = make_optimizer(jcfg, 7)
    kw = dict(n_sources=2, frame_interval=1, n_frames=4, seed=42)
    jbatch = jbf.to_model_batch([jbf.BundlefusionDataset("train", bf_root, **kw)[4]], jcfg)
    batch = bf.to_model_batch([bf.BundlefusionDataset("train", bf_root, **kw)[4]], cfg)
    key = jax.random.PRNGKey(17)

    @jax.jit
    def step(params, batch, key):
        def loss_fn(p):
            v = {k: {"params": p[k]} for k in p}
            v["net_rgb"]["batch_stats"] = stats
            loss, metrics, _ = jm.forward(v, batch, key, train=True)
            return loss, metrics

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, metrics, grads

    want = jax.device_get(step(params, {k: jnp.asarray(v) for k, v in jbatch.items()}, key))
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=7, model=port_model(cfg, variables))
    som_inputs = []  # (g_means, g_stds, sorted distances, alphas) of every render chunk
    ray_som = R.ray_som

    def recording_ray_som(m, s, sd, alphas, **kw_):
        som_inputs.append([t.detach().clone() for t in (m, s, sd, alphas)])
        return ray_som(m, s, sd, alphas, **kw_)

    R.ray_som = recording_ray_som
    try:
        got = trainer.train_step(batch, noise=jax_draws(jcfg, key, 1, cfg.n_sources))
    finally:
        R.ray_som = ray_som
    return want, got, trainer, som_inputs, (jbatch, batch)


def test_bf_batch_and_config_match_jax(step_run):
    *_, (jbatch, batch) = step_run
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    want = dataclasses.asdict(bf_tiny(JC))
    got = dataclasses.asdict(bf_tiny(C))
    assert got == {k: want[k] for k in got}
    assert (got["sample_grid_size"], got["som_sigma"], got["reprojection_weight"],
            got["dist2closest_weight"], got["max_sample_depth"], got["std"],
            got["mean_std_floor"]) == (2, 0.02, 5.0, 0.1, 12.0, 0.2, 0.5)


def test_bf_step_loss_and_metrics_match_jax(step_run):
    (loss, want, _), got, *_ = step_run
    assert set(got) == set(want) and np.isfinite(float(loss))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["total_loss"]), float(loss), rtol=1e-3)


@pytest.mark.parametrize("group", GROUPS)
def test_bf_step_gradients_match_jax(step_run, group):
    (_, _, grads), _, trainer, *_ = step_run
    want = {k: v for k, v in W.numpy_grads_from_jax(grads).items() if k.startswith(group)}
    got = {k: p.grad.numpy() for k, p in trainer.model.named_parameters() if k.startswith(group)}
    assert set(got) == set(want) and got
    scale = max(np.linalg.norm(w) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        assert got[k].shape == w.shape and np.isfinite(got[k]).all(), k
        diff = np.linalg.norm(got[k] - w)
        if np.linalg.norm(w) <= 1e-6 * scale:  # zero up to rounding on both sides
            assert diff <= 1e-5 * scale, (k, diff, scale)
            continue
        worst = max(worst, diff / np.linalg.norm(w))
        assert diff / np.linalg.norm(w) <= GRAD_REL_L2, (k, diff / np.linalg.norm(w))
    print(f"{group}: {len(want)} leaves, worst relative L2 {worst:.3e}")


def test_bf_step_ray_som_ties(step_run):
    """RaySOM at som_sigma 0.02 on the step's render inputs: a sample a few
    cm from every prototype sits at the 1e-5 likelihood floor, where
    rounding decides its best prototype. Every ray whose assignment differs
    from JAX's must be a tie within 4 f32 spacings; the count and the KL's
    relative difference are printed."""
    *_, som_inputs, _ = step_run
    assert len(som_inputs) == 4  # 2 sources x 2 chunks of 32 rays
    m, s, d, a = (torch.cat(t).numpy() for t in zip(*som_inputs))
    got = som_against_jax(m, s, d, a, bf_tiny(C), tie_ulps=4)
    print(f"BF tiny step RaySOM inputs ({m.shape[0]} rays x {d.shape[1]} samples, som_sigma "
          f"0.02): {got}")
    assert got["all_near_ties"], got
    assert got["new_vars_rel"] <= 1e-5 and got["loss_kl"] <= 1e-4, got


def test_bf_som_chunk_recorded_on_the_card_against_jax():
    """RaySOM at som_sigma 0.02 on real render inputs: the first 512 rays of
    one training chunk of the BundleFusion preset at the CLI's defaults (B7
    at 640x480, 2048 rays in one chunk; chip_smoke.py's phase 16 on the
    card, `--bf-som-chunk`, after 6 steps on its fake tree), the port's
    RaySOM against JAX's `ray_som`: every ray whose best prototype differs
    is a rounding tie within 4 f32 spacings (the count and the KL's
    relative difference printed), rays without one at the near-prototype
    bounds; the EM the card ran inside kernel C against its plain version
    here at chip_smoke.py's bounds."""
    from scenerf_tpu_torch.som import som_em_plain

    chunk = np.load(os.path.join(os.path.dirname(__file__), "_torch_som_bf_chunk.npz"))
    cfg = C.bundlefusion()
    assert float(chunk["som_sigma"]) == cfg.som_sigma
    m, s, d, a = (chunk[k] for k in ("gauss_means", "gauss_stds", "sensor_distances", "alphas"))
    got = som_against_jax(m, s, d, a, cfg, tie_ulps=4)
    print(f"BF chunk ({m.shape[0]} rays x {d.shape[1]} samples, recorded on "
          f"{chunk['card']}): {got}")
    assert got["all_near_ties"], got
    assert got["new_means"] <= 1e-5 * np.abs(d).max() and got["new_vars_rel"] <= 1e-5, got
    assert got["loss_kl"] <= 1e-4, got
    em = som_em_plain(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (m, s, d, a)),
                      cfg.som_sigma, cfg.som_mask_threshold)
    agree = np.ones(m.shape[0], bool)
    for x, k in zip(em[:2], ("kernel_new_means", "kernel_new_vars")):
        agree &= np.isclose(x.numpy(), chunk[k], rtol=1e-4, atol=1e-4).all(axis=1)
    agree &= (em[2].numpy() == chunk["kernel_mask"]).all(axis=1)
    assert agree.mean() >= 0.999, agree.mean()


# ------------------------------------------------------ train-bundlefusion


@pytest.mark.parametrize("flags", [
    [],
    ["--n_rays", "600", "--n_sources", "3", "--lr", "3e-5", "--n_gaussians", "3",
     "--std", "0.5", "--som_sigma", "0.1", "--add_fov_hor", "10", "--sphere_w", "480",
     "--sphere_h", "360", "--sample_grid_size", "1", "--sampling_method", "log",
     "--img_w", "320", "--img_h", "240", "--encoder", "effnet-b0", "--encoder_features", "1280",
     "--compute_dtype", "bfloat16", "--exp_prefix", "run"]])
def test_cli_flags_give_the_jax_config_and_name(bf_root, monkeypatch, flags):
    seen = {}

    def capture(side):
        def run_training(cfg, train_ds, val_ds, collate, exp_name, *a, **kw):
            seen[side] = (cfg, exp_name, len(train_ds), len(val_ds), train_ds.n_sources,
                          kw.get("limit_train_fraction"), kw.get("max_steps_per_epoch"))
        return run_training

    monkeypatch.setattr(jax_train_cli, "run_training", capture("jax"))
    monkeypatch.setattr(train_cli, "run_training", capture("port"))
    args = ["--root", bf_root, "--max_steps_per_epoch", "2", *flags]
    runner = CliRunner()
    res = runner.invoke(jax_train_cli.train_bundlefusion, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    res = runner.invoke(train_cli.cli, ["train-bundlefusion", *args, "--device", "cpu"],
                        catch_exceptions=False)
    assert res.exit_code == 0, res.output
    (jcfg, *jrest), (cfg, *rest) = seen["jax"], seen["port"]
    assert rest == jrest and rest[4] == 1.0
    want = dataclasses.asdict(jcfg)
    for k, v in dataclasses.asdict(cfg).items():
        assert v == want[k], k
    assert cfg.sphere.v_angle_min == C.bundlefusion().sphere.v_angle_min
    if not torch.cuda.is_available():  # the default device is the card's
        res = runner.invoke(train_cli.cli, ["train-bundlefusion", *args])
        assert res.exit_code == 2 and "no CUDA device" in res.output


def test_train_bundlefusion_runs_and_resumes_on_cpu(bf_root, tmp_path):
    """2 steps on apt0 and a val batch, then a second run of the same logdir
    that resumes at step 2 and takes one more epoch."""
    args = ["train-bundlefusion", "--root", bf_root, "--logdir", str(tmp_path), "--encoder",
            "tiny", "--encoder_features", "64", "--img_w", "64", "--img_h", "48", "--sphere_w",
            "80", "--sphere_h", "64", "--n_rays", "64", "--n_gt_depth", "32",
            "--sequences", "apt0", "--max_steps_per_epoch", "2", *WINDOW, "--device", "cpu"]
    runs = [CliRunner().invoke(train_cli.cli, args + ["--n_epochs", str(n)],
                               catch_exceptions=False, standalone_mode=False).return_value
            for n in (1, 2)]
    assert (runs[0]["start_step"], runs[1]["start_step"], runs[1]["trainer"].step) == (0, 2, 4)
    assert runs[1]["trainer"].steps_per_epoch == 2
    for run in runs:
        assert len(run["loss"]) == 2 and np.isfinite(run["loss"]).all()
        (vm,) = run["val_metrics"]
        assert np.isfinite(list(vm.values())).all() and "depth/abs_rel" in vm
    meta = runs[1]["checkpoints"].read_meta()
    assert meta["last_step"] == 4 and meta["config"]["name"] == "bundlefusion"


# ------------------------------------------------------ converted weights


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A JAX checkpoint of the BundleFusion tiny config and its conversion."""
    jcfg = bf_tiny(JC, **JCFG)
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=21)
    trainer = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]), steps_per_epoch=5)
    params = {k: variables[k]["params"] for k in variables}
    state = TrainState.from_variables(variables, trainer.tx.init(params), step=3)
    src, dst = (str(tmp_path_factory.mktemp(n)) for n in ("jax_ckpt", "port_ckpt"))
    JaxCheckpointManager(src).save(state, jcfg, metrics={"depth/abs_rel": 0.5})
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint_torch",
        os.path.join(REPO, "scripts", "convert_jax_checkpoint_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.convert(src, dst) == ["last", "best"]
    return src, dst, variables


@pytest.mark.parametrize("sphere_wh", [(81, 65), (80, 64)])
def test_converted_bf_checkpoint_renders_like_jax(bf_root, ckpts, monkeypatch, sphere_wh):
    """A val item's render at a source pose through `load_model` of the
    converted checkpoint against JAX's `load_model`, at the test sphere and
    at 80x64, where the principal axes fall on .5 cell boundaries: there
    every ray whose samples include one within 1e-4 of such a boundary (a
    rounding tie, counted and printed) may differ; every other ray is held
    at rtol 1e-3."""
    src, dst, variables = ckpts
    model = load_model(dst, "cpu")
    assert model.cfg == bf_tiny(C)
    want_sd = port_model(model.cfg, variables).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    jm, state, jcfg = jcommon.load_model(src)
    if sphere_wh != SPHERE_WH:
        sphere = dataclasses.replace(model.cfg.sphere, width=sphere_wh[0], height=sphere_wh[1])
        jm = JaxSceneRF(jcfg.replace(sphere=sphere))
        sd = model.state_dict()
        model = SceneRF(model.cfg.replace(sphere=sphere)).eval()
        model.load_state_dict(sd)
    item = bf.BundlefusionDataset("val", bf_root, n_sources=1, frame_interval=1, n_frames=4,
                                  seed=0)[1]
    K, T = item["cam_K"], item["T_source2infers"][0]
    maps = model.compute_sphere_maps(K)
    pix, _ = common.strided_pixel_grid(SIZE, 3)
    key = jax.random.PRNGKey(4)
    k_uni, k_gauss = jax.random.split(key)
    n = len(pix)

    @jax.jit
    def jax_render(v, x, K_, mp, T_, p, k):
        levels, _ = jm.encode(v, x, K_, sphere_maps=mp)
        return jm.render_rays(v, jm.pyramid_for_item(levels, 0), K_, T_, p, k, ray_chunk=n)

    want = np.asarray(jax_render(state.variables(), jnp.asarray(item["img_input"][None]),
                                 jnp.asarray(K), maps, jnp.asarray(T), jnp.asarray(pix),
                                 key)["depth"])
    tie = np.zeros(n, bool)
    sphere_coords = geo.sphere_coords_from_pixels

    def recording(inv_K, sphere, pix=None, img_size=None, round_coords=True):
        if pix is not None and round_coords and len(pix) % n == 0:
            c = sphere_coords(inv_K, sphere, pix=pix, round_coords=False)[1]
            near = ((c - torch.floor(c) - 0.5).abs() < 1e-4).any(-1)
            tie[:] |= near.reshape(n, -1).any(1).numpy()
        return sphere_coords(inv_K, sphere, pix=pix, img_size=img_size,
                             round_coords=round_coords)

    pyramid = E.FrameEncoder(model)(item)
    monkeypatch.setattr(geo, "sphere_coords_from_pixels", recording)
    got, _ = E.render_depth_at_pixels(
        model, pyramid, K, T, pix, n, None,
        noise_uni=torch.tensor(np.asarray(JS.row_noise(k_uni, n, jcfg.n_pts_uni, n, 0))),
        noise_gauss=torch.tensor(np.asarray(JS.row_noise(
            k_gauss, n, jcfg.n_gaussians * jcfg.n_pts_per_gaussian, n, 0, dist="normal"))))
    off = ~np.isclose(got, want, rtol=1e-3, atol=0)
    print(f"sphere {sphere_wh}: {tie.sum()} of {n} rays with a sample at a .5 cell boundary, "
          f"{off.sum()} beyond rtol 1e-3")
    assert not (off & ~tie).any(), np.flatnonzero(off & ~tie)
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-3)
    if sphere_wh != SPHERE_WH:  # at least the 22 rays of the principal row tie
        assert tie.sum() >= len(range(0, SIZE[0], 3)), tie.sum()


# ---------------------------------------------------------- eval commands


def jax_noise_render(monkeypatch, cfg):
    """Make the port's evaluation renders draw JAX's noise: the key of a
    render is fold_in(PRNGKey(0), seed), the seed the port gives its
    generator; the rows are drawn over the rays padded to the chunk."""
    render = E.render_depth_at_pixels

    def fed(model, pyramid, cam_K, T, pixels, chunk, generator, **kw):
        key = jax.random.fold_in(jax.random.PRNGKey(0), generator.initial_seed())
        n = len(pixels)
        n_pad = -(-n // chunk) * chunk
        k_uni, k_gauss = jax.random.split(key)
        nu = np.array(JS.row_noise(k_uni, n_pad, cfg.n_pts_uni))[:n]
        ng = np.array(JS.row_noise(k_gauss, n_pad, cfg.n_pts_gauss, dist="normal"))[:n]
        return render(model, pyramid, cam_K, T, pixels, chunk, None,
                      noise_uni=torch.from_numpy(nu), noise_gauss=torch.from_numpy(ng))

    monkeypatch.setattr(E, "render_depth_at_pixels", fed)


def jit_jax_encode(monkeypatch):
    """JAX's CLI `encode_frame` compiled, once per config, where the commands
    run it op by op: the same function of the same inputs, traced and
    compiled once instead of dispatched as hundreds of small programs."""
    encoders = {}

    def encode_frame(model, state, img_input, cam_K):
        variables = state.variables()
        if img_input.ndim == 3:
            img_input = img_input[None]
        if model.cfg not in encoders:
            encoders[model.cfg] = jax.jit(
                lambda v, x, k, m=model: m.encode(v, x, k, train=False)[0])
        return encoders[model.cfg](variables, jnp.asarray(img_input), jnp.asarray(cam_K)), \
            variables

    monkeypatch.setattr(jcommon, "encode_frame", encode_frame)


def _invoke(group, args):
    res = CliRunner().invoke(group, args, catch_exceptions=False, standalone_mode=False)
    assert res.exit_code == 0, res.output
    return res.return_value


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_eval_commands_match_jax(bf_root, ckpts, tmp_path, monkeypatch, capsys):
    src, dst, _ = ckpts
    cfg = bf_tiny(C)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    jargs = ["--root", bf_root, "--model_path", src, "--eval_save_dir", theirs, *EVAL_WINDOW,
             "--n_devices", "1"]
    args = ["--root", bf_root, "--model_path", dst, "--eval_save_dir", ours, *EVAL_WINDOW,
            "--device", "cpu"]
    saved = {}

    def capture(mod):
        save = mod.save_color_png

        def save_color_png(path, color):
            saved[path] = np.array(color, np.float32)
            save(path, color)

        monkeypatch.setattr(mod, "save_color_png", save_color_png)

    capture(jcommon)
    capture(common)
    jit_jax_encode(monkeypatch)
    for cmd in (jeval.save_depth_metrics_bf, jeval.render_colors_bf):
        res = CliRunner().invoke(cmd, jargs)
        assert res.exit_code == 0, res.output
    jax_noise_render(monkeypatch, cfg)
    done = _invoke(E.cli, ["save-depth-metrics-bf", *args])
    assert done["frames"] == ["000004"] and done["rays"] == [[SIZE[0] * SIZE[1]] * 8]

    # the depth pickles: every frame's errors per distance
    for name in ("000004.npy",):
        with open(os.path.join(ours, "depth_metrics", "copyroom", name), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(theirs, "depth_metrics", "copyroom", name), "rb") as f:
            want = pickle.load(f)
        assert got["n_frames"] == want["n_frames"] and sum(got["n_frames"].values()) == 8
        for k, w in want["depth_errors"].items():
            g = got["depth_errors"][k]
            n = got["n_frames"][k]
            np.testing.assert_allclose(g[:4], w[:4], rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(g[4:], w[4:], rtol=0, atol=n * 1e-3, err_msg=name)
    agg = _invoke(E.cli, ["agg-depth-metrics-bf", "--eval_save_dir", ours])
    capsys.readouterr()
    E._agg_depth_metrics_impl(ours, ["copyroom"])
    port_out = capsys.readouterr().out
    jagg = jeval._agg_depth_metrics_impl(ours, ["copyroom"])
    assert capsys.readouterr().out == port_out and sum(agg[1].values()) == 8
    for g, w in zip(agg, jagg):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])

    # the color renders, upsampled to 640x480, and the source copies
    done = _invoke(E.cli, ["render-colors-bf", *args])
    assert done["images"] == 8
    names = sorted(os.listdir(os.path.join(theirs, "render_rgb", "copyroom")))
    assert len(names) == 8
    for sub in ("rgb", "render_rgb"):
        assert sorted(os.listdir(os.path.join(ours, sub, "copyroom"))) == names
        for n in names:
            g, w = (saved[os.path.join(d, sub, "copyroom", n)] for d in (ours, theirs))
            assert g.shape == w.shape == ((480, 640, 3) if sub == "render_rgb" else (48, 64, 3))
            if sub == "rgb":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6)
            pg, pw = (np.array(Image.open(os.path.join(d, sub, "copyroom", n)), np.int16)
                      for d in (ours, theirs))
            assert np.abs(pg - pw).max() <= 1
    scores = _invoke(E.cli, ["eval-color-bf", "--eval_save_dir", ours, "--device", "cpu"])
    want = jeval._eval_color_impl(ours, "copyroom", (640, 480))
    for key, w in zip(("psnr", "ssim", "lpips", "count"), want):
        assert scores[key] == w, key
    assert sum(scores["count"].values()) == 8

    # second runs render nothing and write nothing
    stamps = {f: os.stat(os.path.join(ours, f)).st_mtime_ns for f in _files(ours)}
    assert _invoke(E.cli, ["save-depth-metrics-bf", *args])["frames"] == []
    assert _invoke(E.cli, ["render-colors-bf", *args])["images"] == 0
    assert {f: os.stat(os.path.join(ours, f)).st_mtime_ns for f in _files(ours)} == stamps


def test_reconstruction_commands_match_jax(bf_root, ckpts, tmp_path):
    _, dst, _ = ckpts
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    sweep = ["--step", "1.0", "--max_distance", "2.1", *WINDOW]
    done = _invoke(RC.cli, ["generate-novel-depths-bf", "--root", bf_root, "--model_path", dst,
                            "--recon_save_dir", ours, *sweep, "--device", "cpu"])
    assert done["frames"] == ["000002", "000004", "000006"]
    poses = [f"_{s:.2f}_{a:.2f}" for s, a in jgeo.sample_rel_poses_bf(
        angle=30.0, step=1.0, max_distance=2.1)]
    assert poses[:3] == ["_0.00_0.00", "_0.00_-30.00", "_0.00_30.00"] and len(poses) == 9
    for sub, ext in (("depth", ".npy"), ("render_rgb", ".png"), ("depth_visual", ".png")):
        assert sorted(os.listdir(os.path.join(ours, sub, "copyroom"))) == sorted(
            f + p + ext for f in done["frames"] for p in poses)
    depth = np.load(os.path.join(ours, "depth", "copyroom", "000004_1.00_-30.00.npy"))
    assert depth.shape == (48, 64) and np.isfinite(depth).all() and depth.min() > 0

    for sub in ("depth", "render_rgb"):
        shutil.copytree(os.path.join(ours, sub), os.path.join(theirs, sub))
    fused = _invoke(RC.cli, ["depth2tsdf-bf", "--root", bf_root, "--recon_save_dir", ours,
                             *sweep, "--device", "cpu"])
    assert fused["frames"] == done["frames"] and min(fused["verts"]) > 0
    res = CliRunner().invoke(jrecon.depth2tsdf_bf, ["--root", bf_root, "--recon_save_dir",
                                                    theirs, *sweep])
    assert res.exit_code == 0, res.output
    rel = np.stack(list(jgeo.sample_rel_poses_bf(angle=30.0, step=1.0,
                                                 max_distance=2.1).values()))
    K = bf.read_camera_params(os.path.join(bf_root, "copyroom", "info.txt"))[1]
    Ks = np.tile(K.astype(np.float32)[None], (len(rel), 1, 1))
    w2c = np.stack([np.linalg.inv(p) for p in rel]).astype(np.float32)
    near = pixel_ties((120, 120, 96), recon.BF_VOX_ORIGIN.astype(np.float32), 0.04,
                      torch.from_numpy(Ks), torch.from_numpy(w2c), tol=TIE_PX).numpy()
    for f in done["frames"]:
        got, want = (pickle.load(open(os.path.join(d, "tsdf", "copyroom", f + ".pkl"), "rb"))
                     for d in (ours, theirs))
        assert got.keys() == want.keys() == {"tsdf_grid", "verts", "faces", "norms", "colors"}
        differs = got["tsdf_grid"] != want["tsdf_grid"]
        gap = np.abs(got["tsdf_grid"] - want["tsdf_grid"])[differs & ~near]
        print(f"{f}: {differs.mean():.3%} of voxels differ, {(differs & near).mean():.3%} at "
              f"pixel ties ({near.mean():.3%} of the grid); elsewhere by at most "
              f"{gap.max(initial=0):.3e}")
        assert gap.max(initial=0) <= CZ_ULPS_ATOL, gap.max()
        verts, faces, norms = jmesh.marching_cubes(got["tsdf_grid"])
        np.testing.assert_array_equal(got["verts"], verts * np.float32(0.04) + np.float32(
            [-2.4, -2.4, 0.0]))
        np.testing.assert_array_equal(got["faces"], faces)
        np.testing.assert_array_equal(got["norms"], norms)
        if not differs.any():
            for k in ("verts", "faces", "norms", "colors"):
                np.testing.assert_array_equal(got[k], want[k])

    assert _invoke(RC.cli, ["generate-sc-gt-bf", "--root", bf_root, "--recon_save_dir", ours,
                            *WINDOW, "--device", "cpu"])["frames"] == done["frames"]
    got = _invoke(E.cli, ["eval-sc-bf", "--root", bf_root, "--recon_save_dir", ours, *WINDOW])
    res = CliRunner().invoke(jeval.eval_sc_bf, ["--root", bf_root, "--recon_save_dir", ours,
                                                *WINDOW], standalone_mode=False)
    assert res.exit_code == 0 and got.keys() == res.return_value.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], res.return_value[k], err_msg=k)

    # second runs write nothing
    stamps = {f: os.stat(os.path.join(ours, f)).st_mtime_ns for f in _files(ours)}
    for cmd, extra in (("generate-novel-depths-bf", ["--model_path", dst]),
                       ("depth2tsdf-bf", []), ("generate-sc-gt-bf", [])):
        flags = sweep if cmd != "generate-sc-gt-bf" else WINDOW
        assert _invoke(RC.cli, [cmd, "--root", bf_root, "--recon_save_dir", ours, *extra,
                                *flags, "--device", "cpu"])["frames"] == []
    assert {f: os.stat(os.path.join(ours, f)).st_mtime_ns for f in _files(ours)} == stamps


def test_cli_help_and_device():
    for group, names in ((E.cli, ("save-depth-metrics-bf", "agg-depth-metrics-bf",
                                  "render-colors-bf", "eval-color-bf", "eval-sc-bf")),
                         (RC.cli, ("generate-novel-depths-bf", "depth2tsdf-bf",
                                   "generate-sc-gt-bf", "determine-angles")),
                         (train_cli.cli, ("train-bundlefusion",))):
        out = CliRunner().invoke(group, ["--help"]).output
        assert all(n in out for n in names), out
    # outside a two-rank world (no torchrun here: one rank) --n_devices 2 refuses
    res = CliRunner().invoke(E.cli, ["save-depth-metrics-bf", "--n_devices", "2", "--device",
                                     "cpu"])
    assert res.exit_code == 2 and "--n_devices 2" in res.output
    assert "the world has 1 rank" in res.output
    if not torch.cuda.is_available():
        for group, cmd in ((E.cli, "render-colors-bf"), (RC.cli, "depth2tsdf-bf"),
                           (RC.cli, "generate-sc-gt-bf")):
            res = CliRunner().invoke(group, [cmd])
            assert res.exit_code == 2 and "no CUDA device" in res.output
