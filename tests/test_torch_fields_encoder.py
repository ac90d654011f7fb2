"""Field MLP, encoder backbone, eval-mode batch norm and the spherical
decoder of the PyTorch port against the JAX package, on the same seeded
weights (made with numpy, converted by utils/weights.py).

Tolerances: ResnetFC rtol=1e-5; batch norm rtol=1e-5; EfficientNet
(width 0.5, depth 0.4, 64 features, 64x48 input) and the decoder at the
`tiny` widths rtol=1e-4, atol=1e-4 (deep conv stacks, different conv
algorithms and summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_sphere_maps, seeded_like
from scenerf_tpu import config as JC
from scenerf_tpu import fields as jfields
from scenerf_tpu.encoder.backbones import EfficientNet as JaxEfficientNet
from scenerf_tpu.encoder.norm import FusedBatchNorm as JaxBatchNorm
from scenerf_tpu.encoder.sphere_decoder import DecoderSphere as JaxDecoder
from scenerf_tpu.encoder.sphere_decoder import resize_bilinear_align_corners as jax_resize
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import fields
from scenerf_tpu_torch.data.synthetic import default_intrinsics
from scenerf_tpu_torch.encoder.backbones import EfficientNet, TinyBackbone
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.encoder.sphere_decoder import (DecoderSphere,
                                                      resize_bilinear_align_corners)
from scenerf_tpu_torch.model import compute_sphere_maps
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _load(module, converted, prefix):
    """Load the converted keys under `prefix` into a standalone module."""
    n = len(prefix) + 1
    sd = {k[n:]: torch.tensor(np.ascontiguousarray(v)) for k, v in converted.items()
          if k.startswith(prefix + ".")}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("d_out", [4, 2])
def test_resnetfc(d_out, rng):
    d_in, d_latent, n_blocks, d_hidden = 42, 62, 2, 32
    z = rng.normal(size=(200, d_latent)).astype(np.float32)
    x = rng.normal(size=(200, d_in)).astype(np.float32)
    net = jfields.ResnetFC(d_out=d_out, n_blocks=n_blocks, d_hidden=d_hidden)
    params = seeded_like(jax.eval_shape(net.init, KEY, z, x), seed=d_out)
    out = {}
    W._resnetfc(out, "mlp", params["params"])
    port = _load(fields.ResnetFC(d_in, d_out, d_latent, n_blocks, d_hidden), out, "mlp")
    want = np.asarray(net.apply(params, z, x))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    if d_out == 4:
        d, c = fields.radiance_outputs(torch.tensor(want))
        jd, jc = jfields.radiance_outputs(jnp.asarray(want))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    else:
        anchors = np.array([12.5, 37.5, 62.5, 87.5], np.float32)
        off = want[:100].reshape(25, 4, 2) * 20
        got_ms = fields.gaussian_params_from_offsets(torch.from_numpy(off),
                                                     torch.from_numpy(anchors), 2.5, 1.5)
        want_ms = jfields.gaussian_params_from_offsets(jnp.asarray(off),
                                                       jnp.asarray(anchors), 2.5, 1.5)
        for g, w in zip(got_ms, want_ms):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_batchnorm_eval(eps, rng):
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    bn = JaxBatchNorm(use_running_average=True, epsilon=eps)
    v = seeded_like(jax.eval_shape(bn.init, KEY, x), seed=1)
    port = FusedBatchNorm(16, eps)
    out = {}
    W._bn(out, "bn", v["params"], v["batch_stats"])
    _load(port, out, "bn")
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(bn.apply(v, x)), rtol=1e-5, atol=1e-6)


def test_efficientnet_eval(rng):
    x = rng.normal(size=(1, 48, 64, 3)).astype(np.float32)
    net = JaxEfficientNet(width=0.5, depth=0.4, num_features=64, remat=False)
    v = seeded_like(jax.eval_shape(net.init, KEY, x), seed=2)
    out = {}
    W._backbone(out, v["params"], v["batch_stats"])
    port = _load(EfficientNet(width=0.5, depth=0.4, num_features=64), out, W.ENCODER)
    want = jax.jit(net.apply)(v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and np.isfinite(w).all(), k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def tiny_maps():
    jcfg = JC.tiny()
    return jax_sphere_maps(jcfg, default_intrinsics(C.tiny()))


def test_decoder_tiny_with_jax_maps(tiny_maps, rng):
    cfg = C.tiny()
    chans = TinyBackbone(cfg.encoder_features).tap_channels
    sizes = {"s1": (48, 64), "s2": (24, 32), "s4": (12, 16), "s8": (6, 8), "s16": (3, 4),
             "s32": (2, 2)}
    taps = {k: rng.normal(size=(2, *sizes[k], chans[k])).astype(np.float32) for k in sizes}
    dec = JaxDecoder(num_features=cfg.encoder_features, sphere=JC.tiny().sphere,
                     remat=False)
    dummy = jnp.zeros((1, 2))
    v = seeded_like(jax.eval_shape(lambda k: dec.init(k, taps, dummy, dummy, maps=tiny_maps),
                                   KEY), seed=4)
    out = {}
    W._decoder(out, v["params"], v["batch_stats"])
    port = _load(DecoderSphere(cfg.encoder_features, chans), out, W.DECODER)
    want = jax.jit(lambda v, t, m: dec.apply(v, t, dummy, dummy, maps=m))(v, taps, tiny_maps)
    with torch.no_grad():
        got = port({k: torch.from_numpy(t) for k, t in taps.items()},
                   {s: torch.from_numpy(m) for s, m in tiny_maps.items()})
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_sphere_maps_match_jax(tiny_maps):
    got = compute_sphere_maps(C.tiny(), default_intrinsics(C.tiny()))
    assert set(got) == set(tiny_maps)
    for s in got:
        np.testing.assert_array_equal(got[s], tiny_maps[s], err_msg=str(s))


def test_sphere_maps_match_jax_at_kitti():
    """At 1220x370 a handful of pixels sit on a .5 rounding boundary of the
    sphere grid, where a 1-ulp acos/atan2 difference moves them one cell."""
    K = default_intrinsics(C.kitti())
    got = compute_sphere_maps(C.kitti(), K)
    want = jax_sphere_maps(JC.kitti(), K)
    for s in got:
        differ = (got[s] != want[s]).any(-1).mean()
        assert differ < 1e-3, (s, differ)


@pytest.mark.parametrize("hw,out_hw", [((9, 13), (17, 25)), ((1, 5), (3, 1)),
                                       ((4, 4), (4, 4))])
def test_resize_align_corners(hw, out_hw, rng):
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    np.testing.assert_allclose(
        resize_bilinear_align_corners(torch.from_numpy(x), out_hw).numpy(),
        np.asarray(jax_resize(jnp.asarray(x), out_hw)), rtol=1e-5, atol=1e-6)
