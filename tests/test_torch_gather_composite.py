"""The plain PyTorch versions of the port's two kernels against the JAX
functions they replace (on the CPU the wrappers dispatch to them):

* kernel G, `ops.gather.gather_levels`: against `geometry.sample_feats_2d`
  over a pyramid (`rendering.featurize_points`'s coords) and against
  `sphere_decoder.sphere_scatter_gather` (sentinel -10 map cells), at the
  `tiny` widths and one 80-channel level, out-of-bounds coords included;
  atol=1e-6.
* kernel C, `ops.composite.sort_composite`: samples in a random order go to
  the port and in sorted order to JAX's `sort_samples_by_distance` +
  `composite`; rtol=1e-5 on the outputs, argmin indices equal, and
  `closest_pts_to_depth` within CLOSEST_ULPS f32 spacings of its operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from scenerf_tpu import config as JC
from scenerf_tpu import geometry as jgeo
from scenerf_tpu import rendering as JR
from scenerf_tpu import sampling as JS
from scenerf_tpu.encoder.sphere_decoder import sphere_scatter_gather as jax_resample
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.encoder.sphere_decoder import sphere_scatter_gather
from scenerf_tpu_torch.ops.composite import sort_composite
from scenerf_tpu_torch.ops.gather import gather_levels, gather_levels_plain

torch.set_num_threads(1)
HYP = settings(max_examples=8, deadline=None, derandomize=True, database=None)
# shapes come from small sets: each new shape costs JAX compiles
# closest_pts_to_depth = |depth - sample| cancels: the two sides' depths (sums
# of 64 products in another order) differ by up to 7 f32 spacings of depth
# over 2,400 draws of `_samples`, and the difference keeps that absolute
# error, which at tens of metres is more than rtol 1e-5 of a small result
CLOSEST_ULPS = 16


def _jax_pyramid(levels, sphere, coords):
    # eager: under jit XLA contracts the interpolation into fmas, which moves
    # results by a few ulp, past atol=1e-6
    return jnp.concatenate([
        jgeo.sample_feats_2d(lv, coords / s, JR.pyramid_norm_size(sphere, s))
        for lv, s in zip(levels, JR.SCALES)], axis=-1)


@jax.jit
def _jax_sort_composite(sd, dv, density, rgb):
    # JAX sorts first (as render_ray_block does), then composites the sorted samples
    order = jnp.argsort(sd, axis=1)
    s_sd, s_dv, s_rgb = JS.sort_samples_by_distance(sd, dv, rgb)
    out = JR.composite(jnp.take_along_axis(density, order, 1), s_sd, s_dv, s_rgb)
    out["sensor_distance"] = s_sd
    out["closest_idx"] = jnp.argmin(jnp.abs(out["depth"][:, None] - s_dv), axis=1)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@HYP
@given(n=st.sampled_from([1, 300]), wide=st.booleans(), seed=st.integers(0, 2**16))
def test_gather_pyramid_matches_sample_feats_2d(n, wide, seed):
    rng = np.random.default_rng(seed)
    sphere = C.tiny().sphere
    widths = [80 if wide and i == 0 else c for i, c in enumerate((2, 4, 8, 16, 32))]
    levels = [rng.normal(size=(*R.pyramid_level_size(sphere, s), c)).astype(np.float32)
              for s, c in zip(R.SCALES, widths)]
    # rounded sphere cells, a margin of them outside the grid on every side
    coords = np.round(rng.uniform(-6, [sphere.width + 6, sphere.height + 6],
                                  size=(n, 2))).astype(np.float32)
    ix, iy = [], []
    for lv, s in zip(levels, R.SCALES):
        c = _t(coords) if s == 1 else _t(coords) / s
        grid = R.geo.normalize_pix(c, R.pyramid_norm_size(sphere, s))
        a, b = R.geo.unnormalize_coords(grid, lv.shape[0], lv.shape[1])
        ix.append(a)
        iy.append(b)
    got = gather_levels([_t(lv) for lv in levels], torch.stack(ix), torch.stack(iy))
    want = np.asarray(_jax_pyramid([jnp.asarray(lv) for lv in levels], JC.tiny().sphere,
                                   jnp.asarray(coords)))
    assert got.shape == (n, sum(widths))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@HYP
@given(hw=st.sampled_from([(1, 1), (1, 12), (7, 5), (12, 12)]), c=st.sampled_from([3, 80]),
       seed=st.integers(0, 2**16))
def test_gather_resample_matches_sphere_scatter_gather(hw, c, seed):
    h, w = hw
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(2, h, w, c)).astype(np.float32)
    smap = np.floor(rng.uniform(-2, [w + 2, h + 2], size=(9, 11, 2))).astype(np.float32)
    smap[rng.uniform(size=(9, 11)) < 0.3] = -10.0  # out-of-FOV sentinel cells
    got = sphere_scatter_gather(_t(feat), _t(smap))
    for b in range(2):
        want = np.asarray(jax_resample(jnp.asarray(feat[b]), jnp.asarray(smap)))
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-6, rtol=0)
    assert (got[:, smap[..., 0] == -10.0] == 0).all()


def test_gather_levels_checks_its_coords():
    lv = torch.zeros(4, 5, 3)
    with pytest.raises(ValueError, match="shape"):
        gather_levels([lv, lv], torch.zeros(1, 7), torch.zeros(1, 7))
    torch.testing.assert_close(gather_levels([lv], torch.zeros(1, 7), torch.zeros(1, 7)),
                               gather_levels_plain([lv], torch.zeros(1, 7), torch.zeros(1, 7)))


def _samples(rng, R_, n_uni, n_g, clamp_ties):
    """Drawn-order samples like render_ray_block's: stratified uniform
    distances, then Gaussian ones (some clamped to 0.1, i.e. tied)."""
    base = np.linspace(0.2, 100.0, n_uni, dtype=np.float32)
    sd_uni = base + rng.uniform(size=(R_, n_uni)).astype(np.float32) * (99.8 / max(n_uni, 1))
    sd_g = rng.uniform(-20 if clamp_ties else 0.5, 100, size=(R_, n_g)).astype(np.float32)
    sd = np.concatenate([sd_uni, np.maximum(sd_g, 0.1)], axis=1)
    dv = sd * rng.uniform(0.7, 1.0, size=(R_, 1)).astype(np.float32)
    density = np.log1p(np.exp(rng.normal(size=sd.shape) * 2 - 1)).astype(np.float32)
    rgb = rng.uniform(size=(*sd.shape, 3)).astype(np.float32)
    return sd, dv, density, rgb


@HYP
@given(R_=st.sampled_from([1, 64]), pts=st.sampled_from([(0, 12), (8, 12), (32, 32), (21, 3)]),
       clamp_ties=st.booleans(), seed=st.integers(0, 2**16))
def test_sort_composite_matches_sort_then_composite(R_, pts, clamp_ties, seed):
    n_uni, n_g = pts
    rng = np.random.default_rng(seed)
    sd, dv, density, rgb = _samples(rng, R_, n_uni, n_g, clamp_ties)
    got = sort_composite(_t(sd), _t(dv), _t(density), _t(rgb))
    want = _jax_sort_composite(*map(jnp.asarray, (sd, dv, density, rgb)))
    for k in ("depth", "color", "alphas", "weights", "weights_at_depth", "depth_volume"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("sensor_distance", "closest_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert _closest_ok(got["closest_pts_to_depth"].numpy(), want).all()


def _closest_ok(got_closest, want, idx=None):
    """Per ray: `got_closest` within CLOSEST_ULPS f32 spacings of the larger
    operand (|depth|, |sample|) of JAX's |depth - sample| at `idx` (JAX's
    closest_idx by default)."""
    idx = np.asarray(want["closest_idx"]) if idx is None else idx
    depth = np.asarray(want["depth"])
    sample = np.take_along_axis(np.asarray(want["depth_volume"]), idx[:, None], 1)[:, 0]
    spacing = np.spacing(np.maximum(np.abs(depth), np.abs(sample)))
    return np.abs(got_closest - np.abs(depth - sample)) <= CLOSEST_ULPS * spacing


def test_closest_pts_check_rejects_a_one_sample_shift():
    """The spacing tolerance of closest_pts_to_depth accepts the port's value
    where rtol 1e-5 did not (R_=64, pts=(32, 32), clamp_ties, seed 1: one ray
    1.9e-6 off, 4 spacings of its depth), and fails every ray whose
    closest_idx is moved by one sample to a sample of another distance."""
    rng = np.random.default_rng(1)
    sd, dv, density, rgb = _samples(rng, 64, 32, 32, True)
    got = sort_composite(_t(sd), _t(dv), _t(density), _t(rgb))
    want = _jax_sort_composite(*map(jnp.asarray, (sd, dv, density, rgb)))
    closest = got["closest_pts_to_depth"].numpy()
    assert _closest_ok(closest, want).all()
    idx = np.asarray(want["closest_idx"])
    shifted = np.where(idx + 1 < sd.shape[1], idx + 1, idx - 1)
    s_dv = np.asarray(want["depth_volume"])
    moved = (np.take_along_axis(s_dv, shifted[:, None], 1)
             != np.take_along_axis(s_dv, idx[:, None], 1))[:, 0]
    assert moved.sum() >= 60
    assert not _closest_ok(closest, want, shifted)[moved].any()
