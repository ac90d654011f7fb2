"""The import of a published SceneRF Lightning checkpoint into the port
(`scenerf_tpu_torch/utils/port_reference.py`,
`scripts/import_reference_ckpt_torch.py`) against the JAX package's
(`scenerf_tpu/utils/port_reference.py`):

* `config_from_hparams` equals JAX's field by field on the hparams of
  tests/test_port_reference.py at the KITTI and BundleFusion presets, but
  where JAX's is wrong: with `sphere_W` / `sphere_H` in the hparams JAX
  rebuilds the sphere from KITTI's base angles, the port keeps the preset's;
* a checkpoint in the reference's on-disk layout (`state_dict` written by
  the JAX test's `build_fake_reference_sd` from seeded JAX variables of a
  small B0 model, plus the keys the published checkpoints carry and the
  forward never reads; `hyper_parameters` under the reference's flag names)
  imports into a directory whose `load_model` tensors are bit-equal to
  `weights.state_dict_from_jax_variables` of the same variables, with every
  hparam on the config, a trainer that resumes from it, and a render that
  agrees with JAX's at rtol 1e-3 (test_torch_slice.py's render tolerance)
  from the same weights, noise and sphere maps;
* a run resumed from the import writes a new `best` at its first
  validation, which `load_model` then reads;
* a missing key or a wrong shape raises, naming the key, before anything
  is written;
* the script, in a subprocess.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_kitti_tree import REPO
from _torch_parity import jax_sphere_maps, jax_variables
from test_port_reference import build_fake_reference_sd
from scenerf_tpu import config as JC
from scenerf_tpu import sampling as JS
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.utils.port_reference import config_from_hparams as jax_config_from_hparams
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import weights as W
from scenerf_tpu_torch.utils.checkpoint import CheckpointManager, load_model
from scenerf_tpu_torch.utils.port_reference import (config_from_hparams,
                                                    import_reference_checkpoint,
                                                    save_reference_layout)

torch.set_num_threads(1)

# the hparams of tests/test_port_reference.py, as Lightning stores them
HP = {
    "som_sigma": 0.03, "lr": 2e-5, "weight_decay": 1e-6,
    "img_size": [64, 48], "n_rays": 16, "max_infer_depth": 12.0,
    "max_sample_depth": 10.0, "eval_depth": 8.0, "std": 0.3,
    "n_gaussians": 2, "n_pts_uni": 8, "n_pts_per_gaussian": 4,
    "sampling_method": "uniform", "batch_size": 1,
    "add_fov_hor": 5.0, "add_fov_ver": 3.0,
    "sphere_H": 56, "sphere_W": 80,
    "use_color": True, "use_reprojection": True,
}
HP_KEYS = ("som_sigma", "lr", "weight_decay", "n_rays", "std", "n_gaussians", "n_pts_uni",
           "n_pts_per_gaussian", "sampling_method", "batch_size", "use_color",
           "use_reprojection", "max_infer_depth", "max_sample_depth", "eval_depth")
SPHERE = ("width", "height", "add_fov_hor", "add_fov_ver")
BASE_ANGLES = ("v_angle_min", "v_angle_max", "h_angle_min", "h_angle_max")
# the small B0 model of tests/test_torch_weights.py's b0_pair
B0 = dict(encoder="effnet-b0", encoder_features=64)


@pytest.mark.parametrize("preset", ["kitti", "bundlefusion"])
@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "no_sphere"])
def test_config_from_hparams_matches_jax(preset, sphere):
    hp = HP if sphere else {k: v for k, v in HP.items() if not k.startswith("sphere_")}
    base = dict(encoder="effnet-b0", encoder_features=128, n_sources=1, n_gt_depth=8,
                d_hidden=32, n_blocks=3)
    cfg = config_from_hparams(preset, hp, **base)
    jcfg = jax_config_from_hparams(preset, hp, **base)
    want = dataclasses.asdict(jcfg)
    for k, v in dataclasses.asdict(cfg).items():
        if k != "sphere":
            assert v == want[k], k
    for k in HP_KEYS:
        assert getattr(cfg, k) == hp[k], k
    assert cfg.img_size == (64, 48) and cfg.name == preset
    preset_sphere = C.PRESETS[preset]().sphere
    for k in BASE_ANGLES:
        assert getattr(cfg.sphere, k) == getattr(preset_sphere, k), k
    if sphere:
        assert [getattr(cfg.sphere, k) for k in SPHERE] == [80, 56, 5.0, 3.0]
        for k in SPHERE:
            assert getattr(cfg.sphere, k) == getattr(jcfg.sphere, k), k
        # JAX's sphere takes KITTI's base angles whatever the preset
        for k in BASE_ANGLES:
            assert getattr(jcfg.sphere, k) == getattr(C.SphereConfig(), k), k
        if preset == "bundlefusion":
            assert jcfg.sphere.v_angle_min != cfg.sphere.v_angle_min
    else:
        assert dataclasses.asdict(cfg.sphere) == want["sphere"]


def reference_ckpt(state_dict, path, hp=None):
    save_reference_layout(path, state_dict, hp or {})
    return path


def test_import_is_bit_equal_and_renders_like_jax(tmp_path):
    jcfg = jax_config_from_hparams("tiny", HP, **B0)
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=7)
    ckpt = reference_ckpt(build_fake_reference_sd(variables, jcfg.n_blocks),
                          str(tmp_path / "scenerf_fake.ckpt"), HP)
    out = str(tmp_path / "imported")
    cfg, _ = import_reference_checkpoint(ckpt, "tiny", out, **B0)
    assert cfg == config_from_hparams("tiny", HP, **B0)
    for k in HP_KEYS:
        assert getattr(cfg, k) == HP[k], k
    assert cfg.img_size == (64, 48)
    assert [getattr(cfg.sphere, k) for k in SPHERE] == [80, 56, 5.0, 3.0]

    mgr = CheckpointManager(out)
    meta = mgr.read_meta()
    assert mgr.latest() and mgr.best() and (meta["last_step"], meta["best_value"]) == (0, np.inf)
    model = load_model(out, "cpu")
    want = W.state_dict_from_jax_variables(variables)
    got = model.state_dict()
    assert model.cfg == cfg and got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # train-kitti's resume reads `last`
    trainer = Trainer(cfg, device="cpu")
    trainer.load_state_dict(mgr.restore("last"))
    assert trainer.step == 0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    # a render of the imported model against JAX's from the same variables
    K = default_intrinsics(cfg)
    img = input_frame(cfg, seed=2)
    maps = jax_sphere_maps(jcfg, K)
    Wd, Hd = cfg.img_size
    gy, gx = np.meshgrid(np.arange(0, Hd, 4), np.arange(0, Wd, 4), indexing="ij")
    pix = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    R = pix.shape[0]
    key = jax.random.PRNGKey(5)
    k_uni, k_gauss = jax.random.split(key)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.3

    @jax.jit
    def jax_render(v, x, K_, mp, T_, p, k):
        levels, _ = jm.encode(v, x, K_, sphere_maps=mp)
        return jm.render_rays(v, jm.pyramid_for_item(levels, 0), K_, T_, p, k, ray_chunk=R)

    want_depth = np.asarray(jax_render(variables, jnp.asarray(img), jnp.asarray(K), maps,
                                       jnp.asarray(T), jnp.asarray(pix), key)["depth"])
    levels = model.encode(torch.from_numpy(img), K, sphere_maps=maps)
    with torch.no_grad():
        depth = model.render_rays(
            model.pyramid_for_item(levels, 0), torch.from_numpy(K), torch.from_numpy(T),
            torch.from_numpy(pix),
            noise_uni=torch.tensor(np.asarray(JS.row_noise(k_uni, R, cfg.n_pts_uni, R, 0))),
            noise_gauss=torch.tensor(np.asarray(
                JS.row_noise(k_gauss, R, cfg.n_pts_gauss, R, 0, dist="normal"))))["depth"]
    assert np.isfinite(depth.numpy()).all()
    np.testing.assert_allclose(depth.numpy(), want_depth, rtol=1e-3)


def test_a_resumed_run_replaces_the_imported_best(tmp_path):
    torch.manual_seed(3)
    imported = SceneRF(C.tiny()).state_dict()
    out = str(tmp_path / "imported")
    cfg, _ = import_reference_checkpoint(reference_ckpt(imported, str(tmp_path / "t.ckpt")),
                                         "tiny", out)
    # train-kitti's resume and its save after a validation
    mgr = CheckpointManager(out, monitor="depth/abs_rel", mode="min")
    trainer = Trainer(cfg, device="cpu")
    trainer.load_state_dict(mgr.restore("last"))
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    trainer.step = 2
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert mgr.save(trainer.state_dict(), cfg, metrics={"depth/abs_rel": 0.5})
    meta = mgr.read_meta()
    assert (meta["best_value"], meta["best_step"]) == (0.5, 2)
    got = load_model(out, "cpu").state_dict()
    assert any(not torch.equal(trained[k], imported[k]) for k in trained)
    for k, v in trained.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_import_refuses_a_mismatch_before_writing(tmp_path, fault):
    torch.manual_seed(0)
    sd = SceneRF(C.tiny()).state_dict()
    key = "mlp.lin_out.weight"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = torch.zeros(sd[key].shape[0] + 1, *sd[key].shape[1:])
    ckpt = reference_ckpt(sd, str(tmp_path / "bad.ckpt"))
    out = tmp_path / "imported"
    with pytest.raises(ValueError, match=key.replace(".", r"\.")) as err:
        import_reference_checkpoint(ckpt, "tiny", str(out))
    assert ("missing" in str(err.value)) == (fault == "missing")
    assert not out.exists()


def test_script_imports_in_a_subprocess(tmp_path):
    torch.manual_seed(1)
    want = SceneRF(C.tiny()).state_dict()
    ckpt = reference_ckpt(want, str(tmp_path / "tiny.ckpt"), {"som_sigma": 0.5})
    out = tmp_path / "imported"
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                       "import_reference_ckpt_torch.py"),
                          "--ckpt", ckpt, "--preset", "tiny", "--out", str(out)],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    n_params = sum(1 for _ in SceneRF(C.tiny()).parameters())
    assert f"{n_params} param tensors" in res.stdout
    model = load_model(str(out), "cpu")
    assert model.cfg == C.tiny(som_sigma=0.5)
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
