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


def jax_som_p_z_c2(m, s, d, alphas, som_sigma: float) -> np.ndarray:
    """p(z | c2) [R, P, C] as `scenerf_tpu/som.py:52-71` computes it (the
    same jnp ops, eager); its argmax is each sample's best prototype."""
    m, s, d = jnp.asarray(m), jnp.asarray(s), jnp.asarray(d)
    dens = jnp.asarray(alphas) + 1e-8
    dist = jnp.abs(m[:, None, :] - d[:, :, None])
    rel_w = jnp.exp(-((m[:, :, None] - m[:, None, :]) ** 2) / (2.0 * som_sigma ** 2))
    p_c1_given_c2 = rel_w / jnp.sum(rel_w, axis=2, keepdims=True)
    p_z_c1 = (jnp.exp(-(dist ** 2) / (2.0 * (s ** 2)[:, None, :]))
              / (np.sqrt(2.0 * np.pi) * s[:, None, :]) + 1e-5)
    p_z_c1 = p_z_c1 * dens[:, :, None] + 1e-8
    return np.asarray(jnp.einsum("rpc,rkc->rpk", p_z_c1, p_c1_given_c2) + m.shape[1] * 1e-8)


def som_against_jax(m, s, d, alphas, cfg, tie_ulps: int = 4) -> dict:
    """The port's `ray_som` (kernel S's plain version) against the JAX
    package's on the same [R, C] / [R, P] numpy inputs: the share of samples
    and of rays whose best prototype differs; whether every such sample is a
    near tie (JAX's p(z | c2) of the two prototypes within `tie_ulps` f32
    spacings); and, over the rays where no assignment differs, the largest
    differences of new_means, new_vars (relative to the largest) and
    loss_kl, and the relative difference of the mean KL over all rays."""
    import torch

    from scenerf_tpu import som as jsom
    from scenerf_tpu_torch import som

    kw = dict(som_sigma=cfg.som_sigma, mask_threshold=cfg.som_mask_threshold,
              std_floor=cfg.kl_std_floor)
    want = jsom.ray_som(*map(jnp.asarray, (m, s, d, alphas)), **kw)
    ts = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (m, s, d, alphas)]
    got = som.ray_som(*ts, **kw)
    best = som.som_assign_plain(*ts, cfg.som_sigma)[3].numpy()
    p_z_c2 = jax_som_p_z_c2(m, s, d, alphas, cfg.som_sigma)
    jax_best = np.argmax(p_z_c2, axis=2)
    differs = best != jax_best
    p_jax = np.take_along_axis(p_z_c2, jax_best[..., None], 2)[..., 0]
    p_port = np.take_along_axis(p_z_c2, best[..., None], 2)[..., 0]
    near_tie = np.abs(p_jax - p_port) <= tie_ulps * np.spacing(p_jax)
    same = ~differs.any(axis=1)
    new_vars = np.asarray(want.new_vars)
    kl_got, kl_want = got.loss_kl.numpy(), np.asarray(want.loss_kl)
    return {
        "samples_differ": float(differs.mean()),
        "rays_differ": float(1.0 - same.mean()),
        "all_near_ties": bool(near_tie[differs].all()),
        "new_means": float(np.abs(got.new_means.numpy() - np.asarray(want.new_means))[same]
                           .max(initial=0.0)),
        "new_vars_rel": float(np.abs(got.new_vars.numpy() - new_vars)[same].max(initial=0.0)
                              / max(np.abs(new_vars).max(), 1e-12)),
        "loss_kl": float(np.abs(kl_got - kl_want)[same].max(initial=0.0)),
        "loss_kl_mean_rel": float(abs(kl_got.mean() - kl_want.mean())
                                  / max(abs(kl_want.mean()), 1e-12)),
    }


def jax_sphere_maps(jax_cfg, cam_K: np.ndarray):
    """The JAX package's sphere maps for a camera, as `SceneRF.compute_sphere_maps`
    builds them, jitted: {scale: numpy [out_H, out_W, 2]}."""
    def build(K):
        pix, pix_sphere, _ = jgeo.sphere_coords_from_pixels(
            jnp.linalg.inv(K), jax_cfg.sphere, img_size=jax_cfg.img_size)
        return build_sphere_maps(pix, pix_sphere, jax_cfg.sphere)

    return {s: np.asarray(m) for s, m in jax.jit(build)(jnp.asarray(cam_K)).items()}
