"""Geometry, positional encoding and samplers of the PyTorch port against
the JAX package, on the same seeded inputs and injected noise.
Tolerance: atol=1e-5, rtol=1e-5 (f32, different libm and summation order)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenerf_tpu import config as JC
from scenerf_tpu import encoding as jenc
from scenerf_tpu import geometry as jgeo
from scenerf_tpu import sampling as JS
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import encoding as enc
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import sampling as S
from scenerf_tpu_torch.model import SceneRF

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


@pytest.fixture
def cam():
    cfg = C.kitti()
    K = np.array([[732.0, 0, 610.0], [0, 732.0, 185.0], [0, 0, 1]], np.float32)
    T = geo._y_rotation_pose(2.5, 10.0)
    return cfg, K, np.linalg.inv(K).astype(np.float32), T


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_config_matches_jax_fields():
    jax_fields = {f for f in JC.SceneRFConfig.__dataclass_fields__}
    tpu_only = {"featurize_gather", "resample_gather", "decoder_conv", "source_unroll",
                "remat_chunks", "remat_encoder", "remat_decoder", "remat_field"}
    assert set(C.SceneRFConfig.__dataclass_fields__) == jax_fields - tpu_only
    for name in ("kitti", "bundlefusion", "tiny"):
        j, t = JC.PRESETS[name](), C.PRESETS[name]()
        for f in C.SceneRFConfig.__dataclass_fields__:
            tv, jv = getattr(t, f), getattr(j, f)
            if f == "sphere":
                tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
            assert tv == jv, (name, f)
        assert (t.d_in, t.n_pts_per_ray) == (j.d_in, j.n_pts_per_ray)
        assert t.sphere.h_fov == j.sphere.h_fov and t.sphere.v_min == j.sphere.v_min
    assert C.kitti(compute_dtype="bfloat16").dtype == torch.bfloat16
    # the mixed precision builds with f32 parameters and f32 BN statistics
    model = SceneRF(C.tiny(compute_dtype="bfloat16"))
    assert {t.dtype for t in model.state_dict().values()} == {torch.float32}


@pytest.mark.parametrize("fn", ["cam_pts_2_pix", "transform_points", "rotate_vectors"])
def test_projective_ops(cam, fn, rng):
    _, K, _, T = cam
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 10.0  # z <= 0 included
    arg = K if fn == "cam_pts_2_pix" else T
    _close(getattr(geo, fn)(_t(pts), _t(arg)),
           getattr(jgeo, fn)(jnp.asarray(pts), jnp.asarray(arg)))


def test_unprojection_and_ray_directions(cam, rng):
    _, _, inv_K, _ = cam
    pix = rng.uniform(0, [1220, 370], size=(400, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 80, size=(400,)).astype(np.float32)
    _close(geo.pix_2_cam_pts(_t(pix), _t(inv_K), _t(depth)),
           jgeo.pix_2_cam_pts(jnp.asarray(pix), jnp.asarray(inv_K), jnp.asarray(depth)))
    for normalize in (True, False):
        _close(geo.ray_directions(_t(pix), _t(inv_K), normalize),
               jgeo.ray_directions(jnp.asarray(pix), jnp.asarray(inv_K), normalize))


def test_sphere_coords(cam, rng):
    cfg, _, inv_K, _ = cam
    pix = rng.uniform(-5, [1225, 375], size=(2000, 2)).astype(np.float32)
    _, got, gd = geo.sphere_coords_from_pixels(_t(inv_K), cfg.sphere, pix=_t(pix),
                                               round_coords=False)
    _, want, wd = jgeo.sphere_coords_from_pixels(jnp.asarray(inv_K), JC.kitti().sphere,
                                                 pix=jnp.asarray(pix), round_coords=False)
    _close(got, want, atol=1e-3, rtol=1e-5)  # grid cells: 1e-3 of a cell
    _close(gd, wd)
    # rounded cells agree except where a 1-ulp acos/atan2 difference crosses .5
    _, got_r, _ = geo.sphere_coords_from_pixels(_t(inv_K), cfg.sphere, pix=_t(pix))
    _, want_r, _ = jgeo.sphere_coords_from_pixels(jnp.asarray(inv_K), JC.kitti().sphere,
                                                  pix=jnp.asarray(pix))
    assert (got_r.numpy() != np.asarray(want_r)).any(axis=1).mean() < 0.01


def test_round_is_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999], np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(), np.asarray(jnp.round(x)))


def test_pixel_grid_and_pose_sweeps():
    np.testing.assert_array_equal(geo.pixel_grid(7, 5).numpy(),
                                  np.asarray(jgeo.pixel_grid(7, 5)))
    want = jgeo.sample_rel_poses(0.5, 10.0, 10.1)
    got = geo.sample_rel_poses(0.5, 10.0, 10.1)
    assert list(got) == list(want)
    np.testing.assert_array_equal(geo.rel_pose_stack(got), jgeo.rel_pose_stack(want))


@pytest.mark.parametrize("num_freqs", [4, 6])
def test_positional_encoding(num_freqs, rng):
    x = rng.normal(size=(300, 3)).astype(np.float32) * 5.0
    got = enc.positional_encoding(_t(x), num_freqs=num_freqs)
    want = jenc.positional_encoding(jnp.asarray(x), num_freqs=num_freqs)
    assert got.shape[-1] == enc.positional_encoding_dim(num_freqs)
    _close(got, want)


@pytest.mark.parametrize("method", ["uniform", "log"])
def test_sample_rays_uniform_with_injected_noise(cam, method, rng):
    cfg, _, inv_K, T = cam
    pix = rng.uniform(0, [1220, 370], size=(64, 2)).astype(np.float32)
    noise = rng.uniform(size=(64, cfg.n_pts_uni)).astype(np.float32)
    got = S.sample_rays_uniform(None, _t(pix), _t(inv_K), _t(T), cfg.n_pts_uni,
                                cfg.min_sample_depth, cfg.max_sample_depth,
                                method=method, noise=_t(noise))
    want = JS.sample_rays_uniform(None, jnp.asarray(pix), jnp.asarray(inv_K),
                                  jnp.asarray(T), cfg.n_pts_uni, cfg.min_sample_depth,
                                  cfg.max_sample_depth, method=method,
                                  noise=jnp.asarray(noise))
    for g, w in zip(got, want):
        _close(g, w)


def test_sample_rays_gaussian_with_injected_noise(cam, rng):
    cfg, _, inv_K, T = cam
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    means = rng.uniform(0, 100, size=(64, cfg.n_gaussians)).astype(np.float32)
    stds = rng.uniform(1.5, 8, size=(64, cfg.n_gaussians)).astype(np.float32)
    noise = rng.normal(size=(64, cfg.n_pts_gauss)).astype(np.float32) * 10  # clamps too
    got = S.sample_rays_gaussian(None, _t(dirs), _t(T), _t(means), _t(stds),
                                 cfg.n_pts_per_gaussian, cfg.min_clamp_depth, noise=_t(noise))
    want = JS.sample_rays_gaussian(None, jnp.asarray(dirs), jnp.asarray(T),
                                   jnp.asarray(means), jnp.asarray(stds),
                                   cfg.n_pts_per_gaussian, cfg.min_clamp_depth,
                                   noise=jnp.asarray(noise))
    for g, w in zip(got, want):
        _close(g, w)
    _close(S.gaussian_anchor_distances(4, 100.0), JS.gaussian_anchor_distances(4, 100.0))


def test_row_noise_is_chunk_invariant():
    full = S.row_noise(torch.Generator().manual_seed(3), 40, 6, dist="normal")
    part = S.row_noise(torch.Generator().manual_seed(3), 15, 6, full_rows=40,
                       row_offset=20, dist="normal")
    torch.testing.assert_close(part, full[20:35], rtol=0, atol=0)
