"""Weights between the JAX package and the PyTorch port.

* Round trip: JAX variables -> `state_dict_from_jax_variables` -> the port
  (`load_state_dict(strict=True)`) -> `port.state_dict()` ->
  `scenerf_tpu.utils.port_reference.port_reference_state_dict` gives back
  the JAX tree leaf for leaf, bit for bit.
* The full KITTI B7 model: the port's key set and shapes equal the converted
  `jax.eval_shape(SceneRF(kitti()).init)` tree (traced only; the port side
  is built on the meta device, so no B7 weights are materialized).
* A reference Lightning state_dict loads, minus exactly the keys the
  reference forward never reads.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, port_model
from scenerf_tpu import config as JC
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.utils.port_reference import port_reference_state_dict
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def b0_pair():
    """A B0-backbone model at the tiny sizes, in both packages."""
    jcfg = JC.tiny(encoder="effnet-b0", encoder_features=64)
    variables = jax_variables(JaxSceneRF(jcfg), seed=7)
    return variables, port_model(C.tiny(encoder="effnet-b0", encoder_features=64),
                                 variables)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_round_trip_through_port_reference(b0_pair):
    variables, model = b0_pair
    back = port_reference_state_dict(
        {k: v.detach() for k, v in model.state_dict().items()}, n_blocks=2)
    want, got = _leaves(variables), _leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kitti_b7_keys_and_shapes():
    shapes = jax.eval_shape(JaxSceneRF(JC.kitti()).init, jax.random.PRNGKey(0))
    # zero-stride views: the converter transposes views, nothing is allocated
    fake = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    converted = {k: v.shape for k, v in W.numpy_state_dict_from_jax_variables(fake).items()}
    with torch.device("meta"):
        port = SceneRF(C.kitti())
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert set(converted) == set(want)
    assert {k: tuple(s) for k, s in converted.items()} == want
    assert len(want) > 1000
    assert want["net_rgb.encoder.original_model.conv_head.weight"] == (2560, 640, 1, 1)
    assert want["mlp.lin_z.0.weight"] == (512, 2480)
    n_blocks = sum(k.endswith(".conv_pwl.weight") for k in want)
    assert n_blocks == 55 - 4  # the four stage-0 blocks have no expansion


def test_load_reference_state_dict(b0_pair):
    _, model = b0_pair
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    # what a Lightning checkpoint also carries and the reference forward skips
    extra = {f"{W.ENCODER}.bn2.weight": torch.ones(3),
             f"{W.ENCODER}.classifier.weight": torch.ones(2, 3),
             f"{W.DECODER}.resize_output_1_1.weight": torch.ones(1),
             f"{W.ENCODER}.bn1.num_batches_tracked": torch.tensor(5)}
    fresh = SceneRF(C.tiny(encoder="effnet-b0", encoder_features=64))
    W.load_reference_state_dict(fresh, {"state_dict": {**sd, **extra}})
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    sd.pop("mlp.lin_z.0.weight")
    with pytest.raises(RuntimeError, match="lin_z"):
        W.load_reference_state_dict(fresh, sd)
