"""One `tiny` training step (2 sources) of the PyTorch port against the JAX
package's: `jax.value_and_grad(SceneRF.forward)` + the optax AdamW update,
from the same seeded weights, on the same synthetic batch, with every random
draw (training pixels, render noise, reprojection tie-break, GT-depth render
noise) derived from JAX's key as `scenerf_tpu/model.py` derives it and
injected into the port (which runs its kernels' plain versions on the CPU).

Tolerances: loss and every metric rtol 1e-3; every gradient leaf, mapped to
the port's names through the weight bridge, relative L2 <= 1e-3 (printed;
the worst leaf measured 9.7e-5): a sample whose sphere coordinate sits on a
.5 rounding boundary could change cell between the libraries (see
test_torch_slice.py), which this step's samples do not. Leaves whose JAX
gradient is zero up to rounding (a conv bias feeding a train-mode batch
norm, which subtracts it again) are held to an absolute bound instead. BN
running statistics rtol 1e-4; parameters after the AdamW step atol 2 lr, as
the first Adam step moves each weight by about +-lr whatever the gradient's
size, and the update itself, p_after - p_before, within 0.05 lr of optax's
(see test_step_adamw_update_matches_optax). The RaySOM of every render chunk
is also held to the JAX package's on the step's own inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_variables, port_model, som_against_jax
from scenerf_tpu import config as JC
from scenerf_tpu import sampling as JS
from scenerf_tpu.data.synthetic import make_batch as jax_make_batch
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.train import make_lr_schedule, make_optimizer
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.model import NOISE_KEYS
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
STEPS_PER_EPOCH = 7
GROUPS = ("net_rgb.encoder.", "net_rgb.decoder.", "mlp.", "mlp_gaussian.")


def jax_draws(jcfg, key, B: int, S_n: int):
    """Every draw of `SceneRF.forward(key)`: split(key, B) per item
    (model.py:360), split(k, S) per source (:326), split(k, 4) into pixels,
    render, tie-break and GT render keys (:235), and each render's
    split(key) into uniform and Gaussian sample noise (rendering.py:288)."""
    R, G = jcfg.n_rays, jcfg.n_gt_depth
    n_uni, n_g = jcfg.n_pts_uni, jcfg.n_gaussians * jcfg.n_pts_per_gaussian
    W_, H = jcfg.img_size
    out = {k: [[None] * S_n for _ in range(B)] for k in NOISE_KEYS}
    for b, k_item in enumerate(jax.random.split(key, B)):
        for s, k in enumerate(jax.random.split(k_item, S_n)):
            k_pix, k_render, k_noise, k_gt = jax.random.split(k, 4)
            k_uni, k_gauss = jax.random.split(k_render)
            g_uni, g_gauss = jax.random.split(k_gt)
            draws = {
                "pixels": JS.random_grid_pixels(k_pix, R, W_, H, stride=jcfg.pixel_stride,
                                                grid_size=jcfg.sample_grid_size),
                "uni": JS.row_noise(k_uni, R, n_uni, R, 0),
                "gauss": JS.row_noise(k_gauss, R, n_g, R, 0, dist="normal"),
                "reproj": JS.row_noise(k_noise, R, 1, None, 0, dist="normal")[:, 0],
                "gt_uni": JS.row_noise(g_uni, G, n_uni, G, 0),
                "gt_gauss": JS.row_noise(g_gauss, G, n_g, G, 0, dist="normal"),
            }
            for name, v in draws.items():
                out[name][b][s] = np.asarray(v)
    return {k: torch.tensor(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def step_run():
    # remat only schedules recomputation; without it the JAX program compiles faster
    jcfg = JC.tiny(remat_chunks=False, remat_encoder=False)
    cfg = C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=5)
    params = {k: variables[k]["params"] for k in variables}
    stats = variables["net_rgb"]["batch_stats"]
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    jbatch = jax_make_batch(jcfg)
    batch = make_batch(cfg)
    key = jax.random.PRNGKey(21)

    @jax.jit
    def step(params, batch, key):
        def loss_fn(p):
            v = {k: {"params": p[k]} for k in p}
            v["net_rgb"]["batch_stats"] = stats
            loss, metrics, new_v = jm.forward(v, batch, key, train=True)
            return loss, (metrics, new_v["net_rgb"]["batch_stats"])

        (loss, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, metrics, new_stats, grads, optax.apply_updates(params, updates), updates

    want = jax.device_get(step(params, {k: jnp.asarray(v) for k, v in jbatch.items()}, key))

    model = port_model(cfg, variables)
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH, model=model)
    noise = jax_draws(jcfg, key, 1, cfg.n_sources)
    som_inputs = []  # (g_means, g_stds, sorted distances, alphas) of every render chunk
    ray_som = R.ray_som

    def recording_ray_som(m, s, sd, alphas, **kw):
        som_inputs.append([t.detach().clone() for t in (m, s, sd, alphas)])
        return ray_som(m, s, sd, alphas, **kw)

    R.ray_som = recording_ray_som
    try:
        metrics = trainer.train_step(batch, noise=noise)
    finally:
        R.ray_som = ray_som
    return want, metrics, trainer, variables, som_inputs


def test_batch_is_the_jax_batch():
    jb, pb = jax_make_batch(JC.tiny()), make_batch(C.tiny())
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


def test_step_loss_and_metrics_match_jax(step_run):
    (loss, want, *_), got, *_ = step_run
    assert set(got) == set(want)
    assert np.isfinite(float(loss))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["total_loss"]), float(loss), rtol=1e-3)


@pytest.mark.parametrize("group", GROUPS)
def test_step_gradients_match_jax(step_run, group):
    (_, _, _, grads, *_), _, trainer, *_ = step_run
    want = {k: v for k, v in W.numpy_grads_from_jax(grads).items() if k.startswith(group)}
    got = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()
           if k.startswith(group)}
    assert set(got) == set(want) and got
    scale = max(np.linalg.norm(w) for w in want.values())
    worst, n_tiny = 0.0, 0
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.isfinite(got[k]).all(), k
        diff = np.linalg.norm(got[k] - w)
        if np.linalg.norm(w) <= 1e-6 * scale:  # zero up to rounding on both sides
            n_tiny += 1
            assert diff <= 1e-5 * scale, (k, diff, scale)
            continue
        rel = diff / np.linalg.norm(w)
        worst = max(worst, rel)
        assert rel <= 1e-3, (k, rel)
    print(f"{group}: {len(want)} leaves, worst relative L2 {worst:.3e}, "
          f"{n_tiny} zero up to rounding")


def test_step_batch_stats_match_jax(step_run):
    (_, _, new_stats, *_), _, trainer, variables, _ = step_run
    updated = dict(variables)
    updated["net_rgb"] = {"params": variables["net_rgb"]["params"], "batch_stats": new_stats}
    want = {k: v for k, v in W.numpy_state_dict_from_jax_variables(updated).items()
            if k.endswith(("running_mean", "running_var"))}
    state = trainer.model.state_dict()
    assert want
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(state[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3), err_msg=k)
        before = W.numpy_state_dict_from_jax_variables(variables)[k]
        moved += not np.allclose(before, w)
    assert moved == len(want)


def test_step_params_after_adamw_match_optax(step_run):
    (_, _, _, _, new_params, _), _, trainer, *_ = step_run
    lr = trainer.cfg.lr
    want = W.numpy_grads_from_jax(new_params)  # params-shaped: same renaming
    for k, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=2 * lr, err_msg=k)
    assert trainer.step == 1


def test_step_adamw_update_matches_optax(step_run):
    """The update itself, p_after - p_before, against optax's `updates`. Each
    element is held to 0.05 lr, plus lr |g_port - g_jax| / eps (the first
    Adam step is -lr g / (|g| + eps), whose slope in g is at most lr / eps:
    this term matters only where |g| is near eps, as on the leaves whose
    gradient is zero up to rounding), plus one f32 spacing of the weight (the
    rounding of p_after). Where |g| > 100 eps the step has the sign of -g."""
    (_, _, _, grads, _, updates), _, trainer, variables, _ = step_run
    lr, eps = trainer.lr_at(0), 1e-8
    before = W.numpy_grads_from_jax({k: variables[k]["params"] for k in variables})
    want, g_jax = W.numpy_grads_from_jax(updates), W.numpy_grads_from_jax(grads)
    n_big = n_all = 0
    worst = 0.0
    for k, p in trainer.model.named_parameters():
        delta = p.detach().numpy().astype(np.float64) - before[k]
        g = p.grad.numpy()
        lim = (0.05 * lr + lr * np.abs(g - g_jax[k]).astype(np.float64) / eps
               + np.spacing(np.abs(before[k])))
        bad = np.abs(delta - want[k]) > lim
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(delta - want[k]).max()) / lr)
        big = np.abs(g_jax[k]) > 100 * eps
        assert (np.sign(delta[big]) == -np.sign(g_jax[k][big])).all(), k
        n_big, n_all = n_big + int(big.sum()), n_all + g.size
        if big.any():
            worst = max(worst, float(np.abs(delta - want[k])[big].max()) / lr)
    assert n_big > 0.9 * n_all, (n_big, n_all)
    print(f"AdamW step: {n_big} of {n_all} weights with |g| > 100 eps, worst "
          f"|update - optax update| {worst:.2e} lr there")


def test_step_ray_som_on_render_inputs_matches_jax(step_run):
    """RaySOM on the step's own render inputs (every chunk's predicted
    Gaussians and sorted samples with their alphas; most uniform samples lie
    far from every prototype), the port's against the JAX package's. Where a
    sample's likelihoods all sit at the 1e-5 floor its best prototype is
    decided by rounding (see `som_em_plain`); the share of samples and rays
    where the two differ is printed, and new_means, new_vars and the KL are
    held at the bounds of test_torch_train_ops's near-prototype test."""
    *_, som_inputs = step_run
    assert len(som_inputs) == 4  # 2 sources x 2 chunks of 32 rays
    m, s, d, a = (torch.cat(t).numpy() for t in zip(*som_inputs))
    got = som_against_jax(m, s, d, a, C.tiny())
    print(f"tiny step RaySOM inputs ({m.shape[0]} rays x {d.shape[1]} samples): {got}")
    assert got["rays_differ"] == 0.0, got
    assert got["new_means"] <= 1e-5 * np.abs(d).max(), got
    assert got["new_vars_rel"] <= 1e-5, got
    assert got["loss_kl"] <= 1e-4, got


def test_lr_schedule_matches_optax():
    cfg = C.tiny(lr=3e-4, lr_decay_gamma=0.5)
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    sched = make_lr_schedule(JC.tiny(lr=3e-4, lr_decay_gamma=0.5), STEPS_PER_EPOCH)
    for step in (0, 6, 7, 13, 14, 50):
        np.testing.assert_allclose(trainer.lr_at(step), float(sched(step)), rtol=1e-6)
    assert trainer.optimizer.defaults["weight_decay"] == cfg.weight_decay == 0.0
