"""Kernel K5's op (batch norm + activation + residual) of the PyTorch port
against the JAX package's `FusedBatchNorm` followed by `nn.swish`,
`nn.leaky_relu` or nothing, with and without a residual add, through
`jax.vjp`, on the same seeded numpy inputs (JAX eager on the CPU):

* the port's fused module on the CPU (`FusedBatchNorm(act=...)`, the plain
  version with autograd), in train and eval mode at both momentum / eps
  pairs of the model (0.99 / 1e-3 in the backbone, 0.9 / 1e-5 in the
  decoder): y, the updated running statistics, and the gradients of x,
  weight, bias and the residual;
* the plain versions of the kernels' stages (N1 statistics or the eval
  fold, N2 apply, N3 reduce + finalize, N4 dx), composed as the kernels run
  them, for the same y and gradients: the backward's closed form against
  JAX's autodiff;
* the decoder's leaky-ReLU at exact zeros, with the residual, has gradient 1
  there, as JAX's `nn.leaky_relu` (`where(x >= 0, ...)`).

The input has 6 channels (not a multiple of 4), one of them constant (0.5:
mean2 - mean^2 is exactly 0 on both sides, the maximum's gradient tie).
Tolerance: rtol 1e-5 and atol 1e-6 of the largest value of each compared
array (the batch-statistic terms of dx cancel to ~0 in places).
"""
import jax
import jax.numpy as jnp
import flax.linen as jnn
import numpy as np
import pytest
import torch

from _torch_parity import seeded_like
from scenerf_tpu.encoder.norm import FusedBatchNorm as JaxBatchNorm
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.encoder.sphere_decoder import BasicBlock
from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.ops import norm as N
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
RTOL, ATOL_REL = 1e-5, 1e-6
SHAPE = (2, 5, 7, 6)
JAX_ACTS = {"identity": lambda z: z, "silu": jnn.swish, "leaky": jnn.leaky_relu}
CASES = [(act, res, train, mom, eps) for act in N.ACTS for res in (False, True)
         for train in (True, False) for mom, eps in ((0.99, 1e-3), (0.9, 1e-5))]


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * max(np.abs(want).max(), 1e-3), err_msg=what)


def _t(a, grad=False):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, requires_grad=grad)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=SHAPE) * 2 + 0.5).astype(np.float32)
    x[..., 0] = 0.5  # a constant channel
    r = rng.normal(size=SHAPE).astype(np.float32)
    g = rng.normal(size=SHAPE).astype(np.float32)
    return x, r, g


def _jax_reference(act, res, train, mom, eps, x, r, g):
    """(y, updated batch_stats, d_params, d_x, d_r, variables) of JAX's
    FusedBatchNorm + act (+ r) at seeded variables."""
    bn = JaxBatchNorm(use_running_average=not train, momentum=mom, epsilon=eps)
    v = seeded_like(jax.eval_shape(bn.init, jax.random.PRNGKey(0), x), seed=3)

    def fn(params, xx, rr):
        z, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return JAX_ACTS[act](z + rr if res else z), upd

    y, vjp, upd = jax.vjp(fn, v["params"], jnp.asarray(x), jnp.asarray(r), has_aux=True)
    d_params, d_x, d_r = vjp(jnp.asarray(g))
    return y, upd["batch_stats"], d_params, d_x, d_r, v


def _port_module(v, act, mom, eps, train):
    port = FusedBatchNorm(SHAPE[-1], eps, mom, act=act)
    sd = {}
    W._bn(sd, "bn", v["params"], v["batch_stats"])
    port.load_state_dict({k[3:]: _t(a) for k, a in sd.items()})
    return port.train(train)


@pytest.mark.parametrize("act,res,train,mom,eps", CASES)
def test_fused_module_matches_jax(act, res, train, mom, eps, inputs):
    x, r, g = inputs
    want_y, want_stats, d_params, d_x, d_r, v = _jax_reference(act, res, train, mom, eps,
                                                               x, r, g)
    port = _port_module(v, act, mom, eps, train)
    x_t, r_t = _t(x, grad=True), _t(r, grad=True)
    build.reset_launch_counts()
    y = port(x_t, r_t if res else None)
    y.backward(_t(g))
    assert sum(build.LAUNCHES.values()) == 0  # CPU tensors: the plain version
    _close(y, want_y, "y")
    _close(port.running_mean, want_stats["mean"], "running_mean")
    _close(port.running_var, want_stats["var"], "running_var")
    _close(x_t.grad, d_x, "d_x")
    _close(port.weight.grad, d_params["scale"], "d_weight")
    _close(port.bias.grad, d_params["bias"], "d_bias")
    if res:
        _close(r_t.grad, d_r, "d_residual")
    else:
        assert r_t.grad is None


@pytest.mark.parametrize("act,res,train,mom,eps", CASES[::2])
def test_kernel_stages_match_jax(act, res, train, mom, eps, inputs):
    """The kernels' arithmetic in plain ops: N1 (or the eval fold), N2, N3
    with its finalize, N4."""
    x, r, g = inputs
    want_y, want_stats, d_params, d_x, d_r, v = _jax_reference(act, res, train, mom, eps,
                                                               x, r, g)
    port = _port_module(v, act, mom, eps, train)
    x_t, r_t, g_t = _t(x), _t(r) if res else None, _t(g)
    w, b = port.weight.detach(), port.bias.detach()
    if train:
        stats = N.stats_plain(x_t, w, b, port.running_mean, port.running_var, mom, eps)
    else:
        stats = N.fold_plain(w, b, port.running_mean, port.running_var, eps)
    _close(N.apply_plain(x_t, stats, act, r_t), want_y, "y")
    _close(port.running_mean, want_stats["mean"], "running_mean")
    _close(port.running_var, want_stats["var"], "running_var")
    grads = N.bwd_reduce_plain(x_t, g_t, stats, w, eps, act, train, r_t)
    dx, dres = N.bwd_apply_plain(x_t, g_t, stats, grads, act, r_t)
    _close(dx, d_x, "d_x")
    _close(grads[N.DWEIGHT], d_params["scale"], "d_weight")
    _close(grads[N.DBIAS], d_params["bias"], "d_bias")
    if res:
        _close(dres, d_r, "d_residual")
    if train:  # the constant channel is an exact tie: the 0.5 / 0.5 split
        assert float(stats[N.VAR_RAW, 0]) == 0.0


@pytest.mark.parametrize("train", [True, False])
def test_decoder_leaky_gradient_is_one_at_zero(train):
    """A BasicBlock whose second BN outputs exact zeros (weight and bias 0),
    so the block's output is leaky(0 + x) and its gradient in x is leaky'(x)
    alone (with zero BN weight no gradient goes through the conv branch);
    x holds exact zeros, where JAX's nn.leaky_relu has gradient 1."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 5, 3)).astype(np.float32)
    x[0, :, 1:3, :] = 0.0
    block = BasicBlock(3, 1).train(train)
    with torch.no_grad():
        block.conv_block2[1].weight.zero_()
        block.conv_block2[1].bias.zero_()
    x_t = _t(x, grad=True)
    out = block(x_t)
    out.backward(torch.ones_like(out))
    want_out, vjp = jax.vjp(lambda v: jnn.leaky_relu(jnp.zeros_like(v) + v), jnp.asarray(x))
    want_dx, = vjp(jnp.ones_like(want_out))
    want_dx = np.asarray(want_dx)
    assert np.all(want_dx[0, :, 1:3, :] == 1.0)
    _close(out, want_out, "out")
    np.testing.assert_array_equal(x_t.grad.numpy(), want_dx)


def test_kernel_layouts_and_raise_on_unhandled_layout():
    """The kernels take contiguous channel-last (plane 0) and channel-first
    (a permuted NCHW tensor: plane H * W) f32 tensors and raise on anything
    else, rather than copying (checked before any launch)."""
    cl = torch.randn(2, 5, 8, 3)
    cf = torch.randn(2, 3, 5, 8).permute(0, 2, 3, 1)  # [2, 5, 8, 3]
    assert (N.plane(cl), N.plane(cf), N.plane(cl[:, :, ::2])) == (0, 40, None)
    v = torch.ones(3)
    with pytest.raises(ValueError, match="contiguous"):
        N.launch_forward(cl[:, :, ::2], v, v, v, v, True, 0.9, 1e-5, "leaky")
    with pytest.raises(ValueError, match="layout"):
        N.launch_forward(cl, v, v, v, v, True, 0.9, 1e-5, "leaky", residual=cf)
    with pytest.raises(ValueError, match="act must be"):
        N.batch_norm_act(cl, v, v, v, v, True, 0.9, 1e-5, "relu")


def test_kink_ties_mark_pre_activations_at_zero():
    """`kink_ties` flags the elements whose z lies within rounding of the
    leaky-ReLU's kink (the card comparisons zero the cotangent there), and
    nothing for a smooth activation."""
    x = torch.tensor([[1.0, 2.0], [-1.0, 3.0], [1.0 + 2**-22, 2.5]])
    stats = N.fold_plain(torch.ones(2), torch.tensor([-1.0, 0.0]), torch.zeros(2),
                         torch.ones(2) - 1e-5, 1e-5)
    ties = N.kink_ties(x, stats, "leaky")
    assert ties.tolist() == [[True, False], [False, False], [True, False]]
    assert not N.kink_ties(x, stats, "silu").any()
