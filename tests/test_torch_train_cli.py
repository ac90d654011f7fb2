"""The port's training entry point against the JAX package's: the val and
depth-eval steps (the `tiny` preset, the same seeded weights, batch and
injected draws: loss and every metric rtol 1e-3, as
test_torch_train_step.py holds the training step), `forward`'s
`with_losses` / `with_depth_eval`, a resumed run bit-equal to an
uninterrupted one, the last/best checkpoints, `train-kitti`'s flags against
the JAX command's config fields and experiment name, `run_training` end to
end on a small KITTI tree on the CPU, and a JAX checkpoint converted by
`scripts/convert_jax_checkpoint_torch.py`.

The val step's metrics that come from RaySOM's EM (loss_som_kl,
min_som_vars, and total_loss through the KL) are held to JAX's `ray_som` on
the port's own render inputs instead of to JAX's jitted step: on these
weights JAX's jitted forward and the same forward run op by op
(`jax.disable_jit`) disagree on them (loss_som_kl 2.00645 against 1.66490,
min_som_vars 608.55 against 521.80; every other metric within 1e-6), and
the port's val step gives the op-by-op values (1.66484, 521.80). The other
metrics, which carry the RaySOM's inputs (the Gaussians through min_stds and
loss_dist2closest_gauss, the sorted samples and alphas through the depth,
weights_at_depth and closest_pts_to_depth), are held to the jitted step.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from _torch_kitti_tree import REPO, write_kitti_tree
from _torch_parity import jax_sphere_maps, jax_variables, port_model, som_against_jax
from test_torch_train_step import jax_draws
from scenerf_tpu import config as JC
from scenerf_tpu import sampling as JS
from scenerf_tpu import som as JSOM
from scenerf_tpu.cli import train as jax_train_cli
from scenerf_tpu.data.synthetic import make_batch as jax_make_batch
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.parallel.mesh import make_mesh
from scenerf_tpu.train import Trainer as JaxTrainer
from scenerf_tpu.train import TrainState
from scenerf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.cli import train as train_cli
from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils.checkpoint import CheckpointManager, load_model, save_checkpoint

torch.set_num_threads(1)
JCFG = dict(remat_chunks=False, remat_encoder=False)  # remat only reschedules; compiles faster


@pytest.fixture(scope="module")
def eval_run():
    """JAX's val_step and depth_eval_step at step 0, and the draws they made."""
    jcfg, cfg = JC.tiny(**JCFG), C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=8)
    trainer = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]), steps_per_epoch=5)
    params = {k: variables[k]["params"] for k in variables}
    state = TrainState.from_variables(variables, trainer.tx.init(params))
    batch = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg).items()}
    key = jax.random.PRNGKey(13)
    want_val = jax.device_get(trainer.val_step(state, batch, key))
    want_depth = jax.device_get(trainer.depth_eval_step(state, batch, key))
    # the step's key: fold_in(step 0), then the device index (0) on the data axis
    step_key = jax.random.fold_in(jax.random.fold_in(key, 0), 0)
    noise = jax_draws(jcfg, step_key, 1, cfg.n_sources)
    return cfg, variables, noise, want_val, want_depth


SOM_KEYS = ("loss_som_kl", "min_som_vars", "total_loss")  # from RaySOM's EM (see above)


@pytest.mark.parametrize("step", ["val_step", "depth_eval_step"])
def test_eval_steps_match_jax(eval_run, step, monkeypatch):
    cfg, variables, noise, want_val, want_depth = eval_run
    want = want_val if step == "val_step" else want_depth
    trainer = Trainer(cfg, device="cpu", model=port_model(cfg, variables))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    som_inputs = []  # (g_means, g_stds, sorted distances, alphas) of every render chunk
    ray_som = R.ray_som

    def recording_ray_som(m, s, sd, alphas, **kw):
        som_inputs.append([t.detach().clone() for t in (m, s, sd, alphas)])
        return ray_som(m, s, sd, alphas, **kw)

    monkeypatch.setattr(R, "ray_som", recording_ray_som)
    got = getattr(trainer, step)(make_batch(cfg), None, noise=noise)
    assert set(got) == set(want)
    for k in want:
        if not (step == "val_step" and k in SOM_KEYS):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-6,
                                       err_msg=k)
    assert not trainer.model.training and trainer.step == 0
    # nothing moves: the BN statistics stay, no gradient is recorded
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in trainer.model.parameters())
    if step == "depth_eval_step":
        assert not som_inputs  # no training render
        return
    # RaySOM on the port's render inputs (2 sources x 2 chunks), against JAX's
    assert len(som_inputs) == 4
    m, s, d, a = (torch.cat(t).numpy() for t in zip(*som_inputs))
    som = som_against_jax(m, s, d, a, cfg)
    assert som["rays_differ"] == 0.0 and som["new_vars_rel"] <= 1e-5 and som["loss_kl"] <= 1e-4, som
    kl = np.asarray(JSOM.ray_som(*map(jnp.asarray, (m, s, d, a)), som_sigma=cfg.som_sigma,
                                 mask_threshold=cfg.som_mask_threshold,
                                 std_floor=cfg.kl_std_floor).loss_kl)
    want_kl = sum(kl[i * 64:(i + 1) * 64].mean() for i in range(cfg.n_sources))  # per source
    np.testing.assert_allclose(float(got["loss_som_kl"]), want_kl, rtol=1e-3)
    np.testing.assert_allclose(float(got["total_loss"] - got["loss_som_kl"]),
                               float(want["total_loss"] - want["loss_som_kl"]), rtol=1e-3)


def test_forward_without_losses_gives_the_full_forwards_depth_metrics(eval_run):
    cfg, variables, noise, *_ = eval_run
    model = port_model(cfg, variables)
    trainer = Trainer(cfg, device="cpu", model=model)
    tensors, maps = trainer.device_batch(make_batch(cfg))
    with torch.no_grad():
        _, full = model(tensors, noise, train=False, sphere_maps=maps)
        loss, depth = model(tensors, noise, train=False, sphere_maps=maps, with_losses=False)
        _, losses = model(tensors, noise, train=False, sphere_maps=maps, with_depth_eval=False)
    assert set(depth) == {k for k in full if k.startswith("depth/")} | {"total_loss"}
    for k in depth:
        if k != "total_loss":
            assert torch.equal(depth[k], full[k]), k
    assert float(loss) == 0.0 and float(depth["total_loss"]) == 0.0
    assert set(losses) == {k for k in full if not k.startswith("depth/")}
    for k in losses:
        assert torch.equal(losses[k], full[k]), k
    with pytest.raises(ValueError, match="with_depth_eval=True"):
        model(tensors, noise, with_losses=False, with_depth_eval=False)


def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(tmp_path):
    """3 steps against 2 steps, a save, a fresh trainer (other weights)
    loading `last`, and 1 step: parameters, AdamW state, BN statistics, the
    generator and the third step's metrics bit-equal. An epoch is 2 steps,
    so the third step runs at epoch 1's lr."""
    cfg = C.tiny()
    batch = make_batch(cfg)

    def trainer(seed):
        torch.manual_seed(seed)
        return Trainer(cfg, device="cpu", steps_per_epoch=2, model=SceneRF(cfg), seed=3)

    a = trainer(0)
    for _ in range(3):
        want = a.train_step(batch)
    b = trainer(0)
    for _ in range(2):
        b.train_step(batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(b.state_dict(), cfg)
    c = trainer(1)
    c.load_state_dict(mgr.restore("last"))
    assert c.step == 2
    got = c.train_step(batch)
    assert c.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0]["lr"] \
        == cfg.lr * cfg.lr_decay_gamma
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sa, sc = a.model.state_dict(), c.model.state_dict()
    assert any(k.endswith("running_var") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    oa, oc = a.optimizer.state_dict()["state"], c.optimizer.state_dict()["state"]
    assert oa.keys() == oc.keys()
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], oc[i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), c.generator.get_state())


def test_checkpoint_manager_keeps_last_and_best(tmp_path):
    cfg = C.tiny()
    torch.manual_seed(0)
    trainer = Trainer(cfg, device="cpu", model=SceneRF(cfg))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step, value in ((1, 0.5), (2, 0.7), (3, 0.3), (4, None)):
        trainer.step = step
        with torch.no_grad():
            next(trainer.model.parameters()).fill_(float(step))
        improved = mgr.save(trainer.state_dict(), cfg,
                            metrics=None if value is None else {"depth/abs_rel": value})
        assert improved == (step in (1, 3))
    meta = mgr.read_meta()
    assert (meta["last_step"], meta["best_value"], meta["best_step"]) == (4, 0.3, 3)
    assert C.tiny() == load_model(mgr.directory, "cpu").cfg
    assert mgr.restore("last")["step"] == 4 and mgr.restore("best")["step"] == 3
    name = next(iter(trainer.model.state_dict()))
    for path, step in ((mgr.directory, 3), (mgr.best_path, 3), (mgr.last_path, 4)):
        model = load_model(path, "cpu")
        assert float(model.state_dict()[name].flatten()[0]) == step and not model.training
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    # a `max` monitor, and the model-only file of save_checkpoint
    up = CheckpointManager(str(tmp_path / "up"), monitor="total_loss", mode="max")
    assert [up.save(trainer.state_dict(), cfg, {"total_loss": v}) for v in (1, 0, 2)] == \
        [True, False, True]
    save_checkpoint(str(tmp_path / "model.pt"), trainer.model)
    assert torch.equal(load_model(str(tmp_path / "model.pt"), "cpu").state_dict()[name],
                       trainer.model.state_dict()[name])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kitti_tree(str(tmp_path_factory.mktemp("kitti")), {"00": 6, "08": 7})


@pytest.mark.parametrize("flags", [
    [],
    ["--n_rays", "600", "--n_sources", "3", "--lr", "3e-5", "--n_gaussians", "3",
     "--n_pts_per_gaussian", "6", "--std", "1.5", "--som_sigma", "1.0", "--add_fov_hor", "15",
     "--sphere_w", "800", "--sphere_h", "240", "--n_gt_depth", "128", "--use_color", "false",
     "--compute_dtype", "bfloat16", "--encoder", "effnet-b0", "--exp_prefix", "run"]])
def test_cli_flags_give_the_jax_config_and_name(tree, monkeypatch, flags):
    seen = {}

    def capture(side):
        def run_training(cfg, train_ds, val_ds, collate, exp_name, *a, **kw):
            seen[side] = (cfg, exp_name, len(train_ds), len(val_ds), train_ds.n_rays,
                          train_ds.n_sources, kw.get("max_steps_per_epoch"))
        return run_training

    monkeypatch.setattr(jax_train_cli, "run_training", capture("jax"))
    monkeypatch.setattr(train_cli, "run_training", capture("port"))
    common = ["--root", tree, "--preprocess_root", tree, "--sequences", "00",
              "--max_steps_per_epoch", "2", *flags]
    runner = CliRunner()
    res = runner.invoke(jax_train_cli.train_kitti, common, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    res = runner.invoke(train_cli.cli, ["train-kitti", *common, "--device", "cpu"],
                        catch_exceptions=False)
    assert res.exit_code == 0, res.output
    (jcfg, jname, *jrest), (cfg, name, *rest) = seen["jax"], seen["port"]
    assert name == jname and rest == jrest
    want = dataclasses.asdict(jcfg)
    for k, v in dataclasses.asdict(cfg).items():
        assert v == want[k], k
    # the default device is the card's: it refuses to start without CUDA
    if not torch.cuda.is_available():
        res = runner.invoke(train_cli.cli, ["train-kitti", *common])
        assert res.exit_code == 2 and "no CUDA device" in res.output


def test_run_training_end_to_end_on_cpu(tree, tmp_path):
    """2 steps and the val set's one batch, then a second run of the same
    logdir that resumes at step 2 and takes one more epoch."""
    cfg = C.tiny(img_size=(1220, 370))
    kw = dict(n_sources=cfg.n_sources, n_rays=cfg.n_gt_depth, seed=42)
    train_ds = KittiDataset("train", tree, str(tmp_path / "pre"), sequences=["00"], **kw)
    val_ds = KittiDataset("val", tree, str(tmp_path / "pre"), **kw)
    logdir = str(tmp_path / "logs")

    def run(n_epochs):
        return train_cli.run_training(cfg, train_ds, val_ds, lambda it: to_model_batch(it, cfg),
                                      "exp", logdir, n_epochs, True, max_steps_per_epoch=2,
                                      device="cpu")

    first, second = run(1), run(2)
    assert (first["start_step"], second["start_step"], second["trainer"].step) == (0, 2, 4)
    assert len(first["loss"]) == len(second["loss"]) == 2
    assert np.isfinite(first["loss"] + second["loss"]).all()
    for rec in (first, second):
        assert rec["val_items"] == [1]
        (vm,) = rec["val_metrics"]
        assert np.isfinite(list(vm.values())).all() and "depth/abs_rel" in vm
        assert len(rec["train_timings"]["read_s"]) == 2
    meta = second["checkpoints"].read_meta()
    assert meta["last_step"] == 4 and meta["config"] == json.loads(
        json.dumps(dataclasses.asdict(cfg)))
    abs_rel = [first["val_metrics"][0]["depth/abs_rel"], second["val_metrics"][0]["depth/abs_rel"]]
    assert meta["best_value"] == min(abs_rel) and meta["best_step"] == 2 * (1 + np.argmin(abs_rel))
    with open(os.path.join(logdir, "tb", "exp", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 4] and "valdepth/abs_rel" in records[0]


def test_converted_jax_checkpoint_renders_like_jax(tmp_path):
    """A JAX checkpoint directory, converted: the weights and BN statistics
    are bit-equal to the JAX variables through the weight bridge (the
    conversion is exact), and a render from the converted checkpoint agrees
    with JAX's render from the same weights, noise and sphere maps at rtol
    1e-3, test_torch_slice.py's render tolerance: two f32 renders of the two
    libraries differ by up to 1.4e-4 relative here (11% of the rays beyond
    1e-5), so a tighter bound holds for neither the port nor a converted
    checkpoint."""
    jcfg, cfg = JC.tiny(**JCFG), C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=21)
    trainer = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]), steps_per_epoch=5)
    params = {k: variables[k]["params"] for k in variables}
    state = TrainState.from_variables(variables, trainer.tx.init(params), step=7)
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxCheckpointManager(src).save(state, jcfg, metrics={"depth/abs_rel": 0.25})
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint_torch",
        os.path.join(REPO, "scripts", "convert_jax_checkpoint_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.convert(src, dst) == ["last", "best"]
    meta = CheckpointManager(dst).read_meta()
    assert (meta["last_step"], meta["best_step"], meta["best_value"]) == (7, 7, 0.25)
    model = load_model(dst, "cpu")
    want_sd = port_model(cfg, variables).state_dict()
    assert model.cfg == cfg and model.state_dict().keys() == want_sd.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k

    K = default_intrinsics(cfg)
    img = input_frame(cfg, seed=2)
    maps = jax_sphere_maps(jcfg, K)
    W, H = cfg.img_size
    gy, gx = np.meshgrid(np.arange(0, H, 4), np.arange(0, W, 4), indexing="ij")
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

    want = np.asarray(jax_render(variables, jnp.asarray(img), jnp.asarray(K), maps,
                                 jnp.asarray(T), jnp.asarray(pix), key)["depth"])
    levels = model.encode(torch.from_numpy(img), K, sphere_maps=maps)
    with torch.no_grad():
        got = model.render_rays(
            model.pyramid_for_item(levels, 0), torch.from_numpy(K), torch.from_numpy(T),
            torch.from_numpy(pix),
            noise_uni=torch.tensor(np.asarray(JS.row_noise(k_uni, R, cfg.n_pts_uni, R, 0))),
            noise_gauss=torch.tensor(np.asarray(
                JS.row_noise(k_gauss, R, cfg.n_pts_gauss, R, 0, dist="normal"))))["depth"]
    print(f"converted checkpoint's depth: largest relative difference to JAX's "
          f"{np.max(np.abs(got.numpy() - want) / want):.2e} over {R} rays")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
