"""Shared setup of the parity tests between the JAX package and its PyTorch
port (tests/test_torch_*.py): seeded JAX variables without a JAX init, and
the conversion into a port model."""
import jax
import jax.numpy as jnp
import numpy as np

from scenerf_tpu import geometry as jgeo
from scenerf_tpu.encoder.sphere_decoder import build_sphere_maps
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.utils.weights import state_dict_from_jax_variables


def seeded_like(shapes, seed: int):
    """Fill a tree of ShapeDtypeStructs with seeded numpy values scaled like
    a trained network: fan-in-scaled kernels, small biases, BN scale near 1,
    positive running variances."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        shape = s.shape
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif "var" in name:
            v = rng.uniform(0.5, 1.5, size=shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(jax_model: JaxSceneRF, seed: int = 0):
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    return seeded_like(shapes, seed)


def port_model(cfg, variables) -> SceneRF:
    """The port's SceneRF holding the same weights, in eval mode."""
    model = SceneRF(cfg).eval()
    model.load_state_dict(state_dict_from_jax_variables(variables), strict=True)
    return model


def jax_sphere_maps(jax_cfg, cam_K: np.ndarray):
    """The JAX package's sphere maps for a camera, as `SceneRF.compute_sphere_maps`
    builds them, jitted: {scale: numpy [out_H, out_W, 2]}."""
    def build(K):
        pix, pix_sphere, _ = jgeo.sphere_coords_from_pixels(
            jnp.linalg.inv(K), jax_cfg.sphere, img_size=jax_cfg.img_size)
        return build_sphere_maps(pix, pix_sphere, jax_cfg.sphere)

    return {s: np.asarray(m) for s, m in jax.jit(build)(jnp.asarray(cam_K)).items()}
