"""The training render's sort-composite with RaySOM's EM in the same call
(`ops.composite.sort_composite(som=...)`, one launch of kernel C on the
card), on the CPU, where it runs the plain versions:

* it is `sort_composite_plain` followed by `som_em_plain` on the sorted
  samples and alphas, bit for bit, and `ray_som` given its EM outputs is
  `ray_som` computing them;
* against the JAX package's `sampling.py:198 sort_samples_by_distance` +
  `rendering.py:102 composite` + `som.py:37 ray_som`: depth and color within
  rtol 1e-5, the sorted distances exact, RaySOM held by
  `_torch_parity.som_against_jax` with every differing assignment a tie
  within 4 f32 spacings; with exact prototype ties and clamped distance ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import som_against_jax
from scenerf_tpu import rendering as JR
from scenerf_tpu import sampling as JS
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.ops import composite as CM
from scenerf_tpu_torch.som import ray_som, som_em_plain

torch.set_num_threads(1)
CFG = C.kitti()  # som_sigma 2, mask threshold 0.1, KL std floor 1.5


def _inputs(seed: int, n_rays: int, n_uni: int, n_g: int, n_protos: int = 4):
    """Drawn samples (uniform and about each Gaussian, clamped at 0.1 m: ties),
    densities with some saturated alphas, colors, and the Gaussians: at least
    8 m apart, with two equal prototypes (exact argmax ties) on the first 8
    rays."""
    rng = np.random.default_rng(seed)
    means = (np.sort(rng.uniform(2, 60, size=(n_rays, n_protos)), axis=1)
             + np.arange(n_protos) * 8.0).astype(np.float32)
    if n_protos > 1:
        means[:8, 1] = means[:8, 0]
    stds = rng.uniform(1.5, 6.0, size=(n_rays, n_protos)).astype(np.float32)
    pick = rng.integers(0, n_protos, size=(n_rays, n_g))
    sd_g = np.take_along_axis(means, pick, 1) + np.take_along_axis(stds, pick, 1) * np.clip(
        rng.normal(size=(n_rays, n_g)), -2.5, 2.5)
    sd_g[:, ::5] = -1.0  # clamped below: equal distances
    sd_uni = np.sort(rng.uniform(0.5, 90, size=(n_rays, n_uni)), axis=1)
    sd = np.maximum(np.concatenate([sd_uni, sd_g], 1), 0.1).astype(np.float32)
    dv = (sd * rng.uniform(0.7, 1.0, size=(n_rays, 1))).astype(np.float32)
    dens = np.log1p(np.exp(rng.normal(size=sd.shape) * 2 - 1)).astype(np.float32)
    hot = rng.uniform(size=sd.shape) < 0.2
    dens = np.where(hot, 50.0 + dens * 100, dens).astype(np.float32)
    rgb = rng.uniform(size=(*sd.shape, 3)).astype(np.float32)
    return sd, dv, dens, rgb, means, stds


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


@pytest.mark.parametrize("n_uni,n_g,n_protos", [(32, 32, 4), (8, 12, 3), (0, 1, 1), (17, 16, 8)])
def test_fused_entry_is_the_plain_pair(n_uni, n_g, n_protos):
    sd, dv, dens, rgb, means, stds = _inputs(n_uni + n_g, 40, n_uni, n_g, n_protos)
    ins = [_t(a, grad=True) for a in (sd, dv, dens, rgb)]
    m, s = _t(means, grad=True), _t(stds, grad=True)
    build.reset_launch_counts()
    got = CM.sort_composite(*ins, som=CM.SomInputs(m, s, CFG.som_sigma, CFG.som_mask_threshold))
    assert not any(build.LAUNCHES.values())  # the CPU launches no kernel
    want = CM.sort_composite_plain(*ins)
    em = som_em_plain(m, s, want["sensor_distance"], want["alphas"], CFG.som_sigma,
                      CFG.som_mask_threshold)
    assert set(got) == set(want) | set(CM.SOM_KEYS)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, b in zip(CM.SOM_KEYS, em):
        assert torch.equal(got[k], b), k
        assert got[k].grad_fn is None
    assert got["depth"].grad_fn is not None

    kw = dict(som_sigma=CFG.som_sigma, mask_threshold=CFG.som_mask_threshold,
              std_floor=CFG.kl_std_floor)
    given = ray_som(m, s, got["sensor_distance"], got["alphas"], **kw,
                    em=[got[k] for k in CM.SOM_KEYS])
    computed = ray_som(m, s, got["sensor_distance"], got["alphas"], **kw)
    for a, b in zip(given, computed):
        assert torch.equal(a, b)


def test_fused_entry_matches_jax():
    sd, dv, dens, rgb, means, stds = _inputs(7, 96, 32, 32)
    got = CM.sort_composite(*map(_t, (sd, dv, dens, rgb)),
                            som=CM.SomInputs(_t(means), _t(stds), CFG.som_sigma,
                                             CFG.som_mask_threshold))
    order = jnp.argsort(jnp.asarray(sd), axis=1)
    s_sd, s_dv, s_rgb = JS.sort_samples_by_distance(*map(jnp.asarray, (sd, dv, rgb)))
    want = JR.composite(jnp.take_along_axis(jnp.asarray(dens), order, 1), s_sd, s_dv, s_rgb)
    np.testing.assert_array_equal(got["sensor_distance"].numpy(), np.asarray(s_sd))
    assert (got["sensor_distance"].numpy()[:, :-1] == got["sensor_distance"].numpy()[:, 1:]).any()
    for k in ("depth", "color", "alphas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)

    # RaySOM on the sorted samples and alphas the fused call used, against JAX
    s_sd_np, alphas = got["sensor_distance"].numpy(), got["alphas"].numpy()
    em = som_em_plain(*map(_t, (means, stds, s_sd_np, alphas)), CFG.som_sigma,
                      CFG.som_mask_threshold)
    for k, b in zip(CM.SOM_KEYS, em):
        assert torch.equal(got[k], b), k
    res = som_against_jax(means, stds, s_sd_np, alphas, CFG, tie_ulps=4)
    print(f"fused RaySOM vs JAX: {res}")
    assert res["all_near_ties"], res
    assert res["rays_differ"] < 1.0, res
    assert res["new_means"] <= 1e-5 * np.abs(sd).max(), res
    assert res["new_vars_rel"] <= 1e-5, res
    assert res["loss_kl"] <= 1e-4, res
