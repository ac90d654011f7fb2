"""The `tiny` serve slice end to end, JAX package against its PyTorch port
(the port on its plain CPU versions of the kernels): same seeded weights,
same JAX-built sphere maps, same input frame and the same noise (drawn by
JAX as `scenerf_tpu/rendering.py:288-292` draws it, injected into the port).

Tolerances: levels rtol 1e-4; depth and color rtol 1e-3. A sample whose
sphere coordinate sits on a .5 rounding boundary can land in a neighbouring
cell after a 1-ulp difference in acos/atan2 between the two libraries, so
the render comparison counts the rays beyond tolerance and allows at most 1%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_sphere_maps, jax_variables, port_model
from scenerf_tpu import config as JC
from scenerf_tpu import sampling as JS
from scenerf_tpu.data.synthetic import default_intrinsics as jax_intrinsics
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
from scenerf_tpu_torch.model import LEVEL_KEYS

torch.set_num_threads(1)

STRIDE = 4
MAX_BAD_SHARE = 0.01


@pytest.fixture(scope="module")
def slice_run():
    jcfg, cfg = JC.tiny(), C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=11)
    model = port_model(cfg, variables)
    K = default_intrinsics(cfg)
    np.testing.assert_array_equal(K, jax_intrinsics(jcfg))
    img = input_frame(cfg, seed=5)
    maps = jax_sphere_maps(jcfg, K)

    # JAX (jitted: one compile beats eager per-op dispatch here): encode, then
    # render_rays over a strided grid in one block
    jlevels, _ = jax.jit(lambda v, x, k, mp: jm.encode(v, x, k, sphere_maps=mp))(
        variables, jnp.asarray(img), jnp.asarray(K), maps)
    W, H = cfg.img_size
    gy, gx = np.meshgrid(np.arange(0, H, STRIDE), np.arange(0, W, STRIDE), indexing="ij")
    pix = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    R = pix.shape[0]
    key = jax.random.PRNGKey(3)
    k_uni, k_gauss = jax.random.split(key)
    noise_uni = JS.row_noise(k_uni, R, cfg.n_pts_uni, R, 0)
    noise_gauss = JS.row_noise(k_gauss, R, cfg.n_pts_gauss, R, 0, dist="normal")
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 0.5
    jout = jax.jit(lambda v, pyr, k, t, p, kk: jm.render_rays(v, pyr, k, t, p, kk, ray_chunk=R))(
        variables, jm.pyramid_for_item(jlevels, 0), jnp.asarray(K), jnp.asarray(T),
        jnp.asarray(pix), key)

    # port: the same frame, maps, weights and noise
    levels = model.encode(torch.from_numpy(img), K, sphere_maps=maps)
    with torch.no_grad():
        out = model.render_rays(model.pyramid_for_item(levels, 0), torch.from_numpy(K),
                                torch.from_numpy(T), torch.from_numpy(pix),
                                ray_chunk=37,  # ragged chunks: noise is sliced per chunk
                                noise_uni=torch.tensor(np.asarray(noise_uni)),
                                noise_gauss=torch.tensor(np.asarray(noise_gauss)),
                                with_som=True)
    return jlevels, levels, jout, out


def test_slice_levels_match(slice_run):
    jlevels, levels, _, _ = slice_run
    for k in LEVEL_KEYS:
        want = np.asarray(jlevels[k])
        got = levels[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["depth", "color"])
def test_slice_render_matches(slice_run, name):
    _, _, jout, out = slice_run
    want = np.asarray(jout[name])
    got = out[name].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    close = close.reshape(close.shape[0], -1).all(axis=1)
    bad_share = 1.0 - close.mean()
    print(f"{name}: {bad_share:.4%} of {close.size} rays beyond rtol=1e-3")
    assert bad_share <= MAX_BAD_SHARE, bad_share
    # the gaussian heads drive the samples: their outputs agree too
    np.testing.assert_allclose(out["gaussian_means"].numpy(),
                               np.asarray(jout["gaussian_means"]), rtol=1e-4, atol=1e-4)


def test_slice_ray_som_matches(slice_run):
    """The RaySOM, which the port runs only when asked (training), on the same
    rays: its KL per ray and re-estimated variances (rtol 1e-3, as depth)."""
    _, _, jout, out = slice_run
    for k in ("loss_kl", "som_vars"):
        want = np.asarray(jout[k])
        close = np.isclose(out[k].numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
        close = close.reshape(close.shape[0], -1).all(axis=1)
        assert 1.0 - close.mean() <= MAX_BAD_SHARE, (k, 1.0 - close.mean())


def test_slice_reconstruction_matches(slice_run):
    """The slice's render, upsampled 4x to the image size (`jax.image.resize`
    / `reconstruction.upsample_to`), colors quantized as the CLI's PNGs, and
    fused from its pose into a 40x20x60 grid of 1 m voxels by each package's
    TSDFVolume: the TSDF within atol 1e-4 on >= 99% of the voxels either
    observes, occupancy (tsdf2occ) IoU >= 0.99 between the two."""
    from scenerf_tpu.fusion.tsdf import TSDFVolume as JaxTSDFVolume
    from scenerf_tpu.fusion.tsdf import tsdf2occ as jax_tsdf2occ
    from scenerf_tpu_torch.fusion.tsdf import TSDFVolume, tsdf2occ
    from scenerf_tpu_torch.reconstruction import quantize_colors, upsample_to
    from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

    _, _, jout, out = slice_run
    cfg = C.tiny()
    W, H = cfg.img_size
    h, w = -(-H // STRIDE), -(-W // STRIDE)
    K = default_intrinsics(cfg)
    T = np.eye(4)
    T[2, 3] = 0.5
    bnds = np.array([[-20.0, 20.0], [-10.0, 10.0], [0.0, 60.0]])
    jd = np.asarray(jax.image.resize(jnp.asarray(jout["depth"]).reshape(h, w), (H, W),
                                     method="bilinear"))
    jc = np.asarray(jax.image.resize(jnp.asarray(jout["color"]).reshape(h, w, 3), (H, W, 3),
                                     method="bilinear"))
    jvol = JaxTSDFVolume(bnds, voxel_size=1.0)
    jvol.integrate((np.clip(jc, 0, 1) * 255).astype(np.uint8).astype(np.float32), jd, K, T)
    vol = TSDFVolume(bnds, voxel_size=1.0, device="cpu")
    vol.integrate(quantize_colors(upsample_to(out["color"].reshape(h, w, 3), (H, W))),
                  upsample_to(out["depth"].reshape(h, w), (H, W)), K, T)

    want, got = jvol.get_volume()[0], vol.get_volume()[0]
    observed = (want != 255) | (got != 255)
    assert observed.sum() > 100
    share = np.isclose(got, want, rtol=0, atol=1e-4)[observed].mean()
    print(f"TSDF within 1e-4 on {share:.4%} of {observed.sum()} observed voxels")
    assert share >= 0.99, share
    m = SSCMetrics(2)
    m.add_batch(tsdf2occ(got, 0.25, 6.0, voxel_size=1.0)[None],
                jax_tsdf2occ(want, 0.25, 6.0, voxel_size=1.0)[None])
    assert m.get_stats()["iou"] >= 0.99, m.get_stats()
