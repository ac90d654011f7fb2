"""The training-step ops of the PyTorch port against the JAX package, on the
same seeded numpy inputs (the port on its plain CPU versions of the kernels,
JAX eager on the CPU so that XLA does not contract products into fmas):

* the VJP of `gather_levels` (kernel G-bwd's plain version) against
  `jax.vjp` of the pyramid sampling (`sample_feats_2d` per level) for the
  level gradients, and of `sample_pix_features` for the image and pixel
  gradients (the reprojection path);
* the backward of `sort_composite_plain` (kernel C-bwd's plain version)
  against `jax.vjp` of `sort_samples_by_distance` + `composite`, with
  saturated alphas, clamped ties and fewer than 64 samples;
* `ray_som` (kernel S's plain version and the KL) and its gradient, near
  the prototypes and on a recorded KITTI render chunk;
* batch norm in train mode (output, gradients, updated running statistics)
  at momenta 0.99 and 0.9, and a small EfficientNet in train mode;
* every loss and metric of `losses.py`, `random_grid_pixels` and the
  synthetic batches.

Tolerance: rtol 1e-5 on every op and VJP (atol 1e-6 of the largest value,
for entries that cancel to ~0). The KL of the RaySOM takes atol 1e-5 of its
largest value and its gradient atol 1e-4: both subtract nearby means
(m - new_mean, about 1 against means up to 100), which turns the last-bit
differences of the EM sums (summed in another order) into absolute errors of
about 1e-7 x 100 in m - new_mean, divided by std^2 >= 2.25 in the gradient.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import seeded_like, som_against_jax
from scenerf_tpu import config as JC
from scenerf_tpu import geometry as jgeo
from scenerf_tpu import losses as JL
from scenerf_tpu import rendering as JR
from scenerf_tpu import sampling as JS
from scenerf_tpu import som as jsom
from scenerf_tpu.data import synthetic as jsyn
from scenerf_tpu.encoder.backbones import EfficientNet as JaxEfficientNet
from scenerf_tpu.encoder.norm import FusedBatchNorm as JaxBatchNorm
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import losses as L
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch import sampling as S
from scenerf_tpu_torch.data import synthetic as syn
from scenerf_tpu_torch.encoder.backbones import EfficientNet
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.ops.composite import sort_composite_plain
from scenerf_tpu_torch.ops.gather import gather_levels
from scenerf_tpu_torch.som import ray_som, som_em_plain
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
RTOL = 1e-5


def _t(a, grad=False):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, requires_grad=grad)


def _close(got, want, rtol=RTOL, what="", atol_rel=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-3), err_msg=what)


# --------------------------------------------------------------- gather VJP


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_levels_vjp_matches_jax(seed):
    """Kernel G-bwd's plain version: the level gradients of the featurize
    gather (rounded sphere cells at every scale, a margin outside the grid)."""
    rng = np.random.default_rng(seed)
    sphere = C.tiny().sphere
    widths = (2, 4, 8, 16, 32)
    levels = [rng.normal(size=(*R.pyramid_level_size(sphere, s), c)).astype(np.float32)
              for s, c in zip(R.SCALES, widths)]
    n = 300
    coords = np.round(rng.uniform(-6, [sphere.width + 6, sphere.height + 6],
                                  size=(n, 2))).astype(np.float32)
    g = rng.normal(size=(n, sum(widths))).astype(np.float32)

    def jax_fn(*lvs):
        return jnp.concatenate([
            jgeo.sample_feats_2d(lv, jnp.asarray(coords) / s, JR.pyramid_norm_size(JC.tiny().sphere, s))
            for lv, s in zip(lvs, JR.SCALES)], axis=-1)

    want_out, vjp = jax.vjp(jax_fn, *map(jnp.asarray, levels))
    want = vjp(jnp.asarray(g))

    lv_t = [_t(lv, grad=True) for lv in levels]
    ix, iy = [], []
    for lv, s in zip(levels, R.SCALES):
        c = _t(coords) if s == 1 else _t(coords) / s
        a, b = geo.unnormalize_coords(geo.normalize_pix(c, R.pyramid_norm_size(sphere, s)),
                                      lv.shape[0], lv.shape[1])
        ix.append(a)
        iy.append(b)
    out = gather_levels(lv_t, torch.stack(ix), torch.stack(iy))
    out.backward(_t(g))
    _close(out, want_out, what="forward")
    for i, (lv, w) in enumerate(zip(lv_t, want)):
        _close(lv.grad, w, what=f"d_level {i}")


def test_sample_pix_features_vjp_matches_jax(rng):
    """The reprojection path: gradients of the sampled colors with respect to
    the image and to the (warped) pixel coords, some of them off the image."""
    H, W_ = 12, 17
    img = rng.uniform(size=(H, W_, 3)).astype(np.float32)
    pix = rng.uniform(-3, [W_ + 2, H + 2], size=(200, 2)).astype(np.float32)
    g = rng.normal(size=(200, 3)).astype(np.float32)
    want_out, vjp = jax.vjp(jgeo.sample_pix_features, jnp.asarray(pix), jnp.asarray(img))
    want_pix, want_img = vjp(jnp.asarray(g))

    pix_t, img_t = _t(pix, grad=True), _t(img, grad=True)
    out = geo.sample_pix_features(pix_t, img_t)
    out.backward(_t(g))
    _close(out, want_out, what="colors")
    _close(img_t.grad, want_img, what="d_img")
    _close(pix_t.grad, want_pix, what="d_pix")


# ------------------------------------------------------- sort + composite VJP


def _samples(rng, n_rays, n_uni, n_g, saturate):
    """Drawn-order samples as render_ray_block makes them: stratified uniform
    distances, then Gaussian ones, some clamped to 0.1 (ties)."""
    base = np.linspace(0.2, 100.0, n_uni, dtype=np.float32)
    sd_uni = base + rng.uniform(size=(n_rays, n_uni)).astype(np.float32) * (99.8 / max(n_uni, 1))
    sd_g = np.maximum(rng.uniform(-20, 100, size=(n_rays, n_g)), 0.1).astype(np.float32)
    sd = np.concatenate([sd_uni, sd_g], axis=1)
    dv = sd * rng.uniform(0.7, 1.0, size=(n_rays, 1)).astype(np.float32)
    density = np.log1p(np.exp(rng.normal(size=sd.shape) * 2 - 1)).astype(np.float32)
    if saturate:  # alpha rounds to 1 on a third of the samples of half the rays
        hot = (rng.uniform(size=sd.shape) < 0.33) & (np.arange(n_rays) % 2 == 0)[:, None]
        density = np.where(hot, 50.0 + density * 100, density).astype(np.float32)
    rgb = rng.uniform(size=(*sd.shape, 3)).astype(np.float32)
    return sd, dv, density, rgb


def _jax_depth_color(sd, dv, density, rgb):
    order = jnp.argsort(sd, axis=1)
    s_sd, s_dv, s_rgb = JS.sort_samples_by_distance(sd, dv, rgb)
    out = JR.composite(jnp.take_along_axis(density, order, 1), s_sd, s_dv, s_rgb)
    return out["depth"], out["color"]


@pytest.mark.parametrize("pts,saturate", [((8, 12), False), ((32, 32), True), ((21, 3), True),
                                          ((0, 1), False)])
def test_sort_composite_vjp_matches_jax(pts, saturate):
    rng = np.random.default_rng(sum(pts))
    n_rays = 64
    ins = _samples(rng, n_rays, *pts, saturate)
    if saturate:
        alphas = 1.0 - np.exp(-np.diff(np.sort(ins[0]), prepend=0.0, axis=1) * ins[2])
        assert (np.float32(alphas) == 1.0).any()
    g_depth = rng.normal(size=(n_rays,)).astype(np.float32)
    g_color = rng.normal(size=(n_rays, 3)).astype(np.float32)
    (want_d, want_c), vjp = jax.vjp(_jax_depth_color, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(g_depth), jnp.asarray(g_color)))

    t = [_t(a, grad=True) for a in ins]
    out = sort_composite_plain(*t)
    torch.autograd.backward([out["depth"], out["color"]], [_t(g_depth), _t(g_color)])
    _close(out["depth"], want_d, what="depth")
    for name, x, w in zip(("d_sd", "d_dv", "d_density", "d_rgb"), t, want):
        assert np.isfinite(x.grad.numpy()).all(), name
        _close(x.grad, w, what=name)


# --------------------------------------------------------------------- SOM


def test_ray_som_and_kl_grads_match_jax(rng):
    """Every sample lies within 2.5 std of a prototype: where a sample is far
    from all of them its likelihoods sit at the 1e-5 floor and its best
    prototype is decided by rounding, differently in XLA's einsum (see
    `som_em_plain`). Rays 0-7 hold two equal prototypes: exact argmax ties,
    which both sides give to the first."""
    n_rays, C_, P = 96, 4, 40
    means = (np.sort(rng.uniform(2, 90, size=(n_rays, C_)), axis=1)
             + np.arange(C_) * 8.0).astype(np.float32)
    means[:8, 1] = means[:8, 0]
    stds = rng.uniform(1.5, 6.0, size=(n_rays, C_)).astype(np.float32)
    pick = rng.integers(0, C_, size=(n_rays, P))
    near = np.take_along_axis(means, pick, 1) + np.take_along_axis(stds, pick, 1) * np.clip(
        rng.normal(size=(n_rays, P)), -2.5, 2.5)
    sd = np.sort(near, axis=1).astype(np.float32)
    alphas = rng.uniform(0, 1, size=(n_rays, P)).astype(np.float32)
    wts = rng.uniform(size=(n_rays,)).astype(np.float32)

    def jax_fn(m, s):
        res = jsom.ray_som(m, s, jnp.asarray(sd), jnp.asarray(alphas), som_sigma=2.0)
        return jnp.sum(res.loss_kl * wts), res

    (want_loss, want), grads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(means), jnp.asarray(stds))

    m_t, s_t = _t(means, grad=True), _t(stds, grad=True)
    got = ray_som(m_t, s_t, _t(sd), _t(alphas), som_sigma=2.0)
    torch.sum(got.loss_kl * _t(wts)).backward()
    for name in ("new_means", "new_vars"):
        _close(getattr(got, name), getattr(want, name), what=name)
    _close(got.loss_kl, want.loss_kl, what="loss_kl", atol_rel=1e-5)
    _close(m_t.grad, grads[0], what="d_means", atol_rel=1e-4)
    _close(s_t.grad, grads[1], what="d_stds", atol_rel=1e-4)
    assert float(want.loss_kl.min()) < float(want.loss_kl.max())


@pytest.mark.parametrize("gap_scale", [1.0, 0.3])
def test_ray_som_on_kitti_chunk_matches_jax(gap_scale):
    """RaySOM on one KITTI training-render chunk: 300 rays x 64 sorted samples
    and 4 predicted Gaussians per ray, recorded on an H100 by
    scripts/som_chunk_torch.py (seeded random weights), with kernel S's
    outputs on them. 11% of its samples lie far from every prototype, with
    all likelihoods at the 1e-5 floor.

    gap_scale 1 keeps the recorded means, 17 m or more apart at som_sigma 2:
    p(c1 | c2) is the identity up to rounding, a far sample's p(z | c2) tie
    exactly and both sides take the first index, so no assignment may
    differ. gap_scale 0.3 pulls each ray's prototypes toward its first, 5-6 m
    apart, as training does where Gaussians meet on one surface: a far
    sample's p(z | c2) are then equal in exact arithmetic only, and XLA's
    einsum and the port round them apart differently (measured: 2% of the
    samples, 47% of the rays). Held: every differing assignment is such a
    tie (within 4 f32 spacings), and rays without one agree at the bounds of
    the near-prototype test. Kernel S's outputs agree with the plain version
    at chip_smoke.py's bounds."""
    chunk = np.load(Path(__file__).with_name("_torch_som_kitti_chunk.npz"))
    cfg = C.kitti()
    m, s, d, a = (chunk[k] for k in ("gauss_means", "gauss_stds", "sensor_distances", "alphas"))
    m = (m[:, :1] + (m - m[:, :1]) * np.float32(gap_scale)).astype(np.float32)
    got = som_against_jax(m, s, d, a, cfg, tie_ulps=4)
    print(f"KITTI chunk, prototype gaps x {gap_scale}: {got}")
    if gap_scale == 1.0:
        assert got["rays_differ"] == 0.0, got
    assert got["all_near_ties"], got
    assert got["rays_differ"] < 1.0, got
    assert got["new_means"] <= 1e-5 * np.abs(d).max(), got
    assert got["new_vars_rel"] <= 1e-5, got
    assert got["loss_kl"] <= 1e-4, got
    if gap_scale == 1.0:  # kernel S on the card against its plain version here
        new_means, new_vars, mask = som_em_plain(*map(_t, (m, s, d, a)), cfg.som_sigma,
                                                 cfg.som_mask_threshold)
        agree = np.ones(m.shape[0], bool)
        for x, k in ((new_means, "kernel_new_means"), (new_vars, "kernel_new_vars")):
            agree &= np.isclose(x.numpy(), chunk[k], rtol=1e-4, atol=1e-4).all(axis=1)
        agree &= (mask.numpy() == chunk["kernel_mask"]).all(axis=1)
        assert agree.mean() >= 0.999, agree.mean()


# -------------------------------------------------------------- batch norm


@pytest.mark.parametrize("momentum,eps", [(0.99, 1e-3), (0.9, 1e-5)])
def test_batchnorm_train_matches_jax(momentum, eps, rng):
    x = (rng.normal(size=(2, 5, 7, 16)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    bn = JaxBatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    v = seeded_like(jax.eval_shape(bn.init, KEY, x), seed=3)

    def jax_fn(params, xx):
        return bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                        mutable=["batch_stats"])

    want_y, updates = jax_fn(v["params"], jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: jax_fn(p, xx)[0], v["params"], jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))

    port = FusedBatchNorm(16, eps, momentum)
    sd = {}
    W._bn(sd, "bn", v["params"], v["batch_stats"])
    port.load_state_dict({k[3:]: _t(a) for k, a in sd.items()})
    port.train()
    x_t = _t(x, grad=True)
    y = port(x_t)
    y.backward(_t(g))
    _close(y, want_y, what="y")
    _close(x_t.grad, d_x, what="d_x")
    _close(port.weight.grad, d_params["scale"], what="d_scale")
    _close(port.bias.grad, d_params["bias"], what="d_bias")
    _close(port.running_mean, updates["batch_stats"]["mean"], what="running_mean")
    _close(port.running_var, updates["batch_stats"]["var"], what="running_var")


def test_efficientnet_train_mode_matches_jax(rng):
    """The backbone's BNs in train mode through the module tree: taps and the
    updated running statistics (rtol=atol=1e-4, as the eval-mode test)."""
    x = rng.normal(size=(1, 48, 64, 3)).astype(np.float32)
    net = JaxEfficientNet(width=0.5, depth=0.4, num_features=64, remat=False)
    v = seeded_like(jax.eval_shape(net.init, KEY, x), seed=2)
    want, upd = jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    conv = {}
    W._backbone(conv, v["params"], v["batch_stats"])
    n = len(W.ENCODER) + 1
    port = EfficientNet(width=0.5, depth=0.4, num_features=64)
    port.load_state_dict({k[n:]: _t(a) for k, a in conv.items()}, strict=True)
    port.train()
    got = port(_t(x))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    new = {}
    W._backbone(new, v["params"], upd["batch_stats"])
    state = port.state_dict()
    stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        np.testing.assert_allclose(state[k[n:]].numpy(), np.asarray(new[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# ------------------------------------------------------------------ losses


def test_l1_color_and_masked_mean(rng):
    a, b = rng.uniform(size=(2, 50, 3)).astype(np.float32)
    _close(L.l1_color_loss(_t(a), _t(b)), JL.l1_color_loss(a, b), what="l1")
    x = rng.normal(size=(50,)).astype(np.float32)
    mask = rng.uniform(size=(50,)) < 0.6
    _close(L.masked_mean(_t(x), torch.from_numpy(mask)), JL.masked_mean(x, mask), what="mean")
    _close(L.masked_mean(_t(x), torch.zeros(50, dtype=torch.bool)),
           JL.masked_mean(x, np.zeros(50, bool)), what="empty mask")


def test_reprojection_loss_and_depth_grad_match_jax(rng):
    cfg = C.tiny()
    W_, H = cfg.img_size
    K = syn.default_intrinsics(cfg)
    inv_K = np.linalg.inv(K).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.3, -0.1, -0.4)
    pix = np.stack([rng.integers(0, W_, 120), rng.integers(0, H, 120)], -1).astype(np.float32)
    img_t = syn.texture(H, W_, 3)
    color_src = rng.uniform(size=(120, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 20, size=(120,)).astype(np.float32)
    depth[:5] = -1.0  # behind the target camera: invalid rays
    noise = rng.normal(size=(120,)).astype(np.float32)
    gl = rng.normal(size=(120,)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jnoise = np.asarray(JS.row_noise(key, 120, 1, None, 0, dist="normal"))[:, 0]

    def jax_fn(d):
        loss, valid = JL.reprojection_loss(key, pix, color_src, d, img_t, inv_K, K, T)
        return jnp.sum(loss * gl), (loss, valid)

    (_, (want, want_valid)), d_depth = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(depth))
    d_t = _t(depth, grad=True)
    loss, valid = L.reprojection_loss(_t(jnoise), _t(pix), _t(color_src), d_t, _t(img_t),
                                      _t(inv_K), _t(K), _t(T))
    torch.sum(loss * _t(gl)).backward()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    _close(loss, want, what="loss")
    _close(d_t.grad, d_depth, what="d_depth")
    assert np.abs(d_t.grad.numpy()).max() > 0
    assert noise.shape == jnoise.shape


def test_dist2closest_gaussian_matches_jax(rng):
    means = rng.uniform(1, 50, size=(80, 4)).astype(np.float32)
    stds = rng.uniform(1.5, 5, size=(80, 4)).astype(np.float32)
    som_vars = rng.uniform(0, 30, size=(80, 4)).astype(np.float32)
    depth = rng.uniform(1, 50, size=(80,)).astype(np.float32)

    def jax_fn(m, d):
        out = JL.dist2closest_gaussian(m, stds, som_vars, d)
        return jnp.sum(out["loss_dist2closest_gauss"]), out

    (_, want), (d_m, d_d) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(means), jnp.asarray(depth))
    m_t, d_t = _t(means, grad=True), _t(depth, grad=True)
    got = L.dist2closest_gaussian(m_t, _t(stds), _t(som_vars), d_t)
    torch.sum(got["loss_dist2closest_gauss"]).backward()
    for k in want:
        _close(got[k], want[k], what=k)
    _close(m_t.grad, d_m, what="d_means")
    assert d_t.grad is None and float(np.abs(np.asarray(d_d)).max()) == 0.0


def test_depth_metrics_match_jax(rng):
    gt = rng.uniform(2, 70, size=(200,)).astype(np.float32)
    pred = (gt * rng.uniform(0.5, 1.6, size=200) + rng.normal(size=200)).astype(np.float32)
    pred[:4] = (-1.0, 0.0, 200.0, 1e-4)  # clamped to [min_depth, max_depth]
    mask = rng.uniform(size=200) < 0.8
    got = L.depth_metrics(_t(gt), _t(pred), mask=torch.from_numpy(mask), max_depth=80.0)
    want = JL.depth_metrics(jnp.asarray(gt), jnp.asarray(pred), mask=jnp.asarray(mask),
                            max_depth=80.0)
    assert tuple(sorted(got)) == tuple(sorted(JL.DEPTH_METRIC_NAMES)) == tuple(
        sorted(L.DEPTH_METRIC_NAMES))
    for k in want:
        _close(got[k], want[k], what=k)


# ------------------------------------------------------ pixels and batches


@pytest.mark.parametrize("grid_size,stride", [(1, 2), (2, 2), (2, 1)])
def test_random_grid_pixels_draws_from_jax_candidates(grid_size, stride):
    """Same candidate pixels and per-cell counts as JAX, drawn without
    replacement (the permutations themselves differ by generator)."""
    W_, H, n = 64, 48, 64
    want = np.asarray(JS.random_grid_pixels(KEY, n, W_, H, stride=stride, grid_size=grid_size))
    got = S.random_grid_pixels(torch.Generator().manual_seed(1), n, W_, H, stride=stride,
                               grid_size=grid_size).numpy()
    assert got.shape == want.shape == (n, 2)
    assert len({tuple(p) for p in got}) == n
    cells = [np.asarray(S.grid_pixels(0, W_, 0, H, stride))] if grid_size == 1 else None
    for p_set in (got, want):
        assert (p_set % stride == 0).all() and (p_set[:, 0] < W_).all() and (p_set[:, 1] < H).all()
    if cells:
        # the candidate enumeration is JAX's meshgrid('ij') order
        xs, ys = np.arange(0, W_, stride), np.arange(0, H, stride)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        np.testing.assert_array_equal(cells[0], np.stack([gx.ravel(), gy.ravel()], -1))
    else:
        per = n // 4
        for i in range(4):
            cy, cx = divmod(i, 2)
            for p_set in (got, want):
                blk = p_set[i * per:(i + 1) * per]
                assert ((blk[:, 0] // (W_ // 2)) == cx).all() and ((blk[:, 1] // (H // 2)) == cy).all()


def test_synthetic_batches_match_jax():
    for jb, pb in ((jsyn.make_batch(JC.tiny(), batch_size=2, seed=4),
                    syn.make_batch(C.tiny(), batch_size=2, seed=4)),
                   (jsyn.make_geometric_batch(JC.tiny(), seed=2),
                    syn.make_geometric_batch(C.tiny(), seed=2))):
        assert set(jb) == set(pb)
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
