"""The port's bf16 compute path (`compute_dtype="bfloat16"`) against the JAX
package's, on the CPU (the port runs its kernels' plain versions), at the
`tiny` preset and small shapes, from the same seeded weights and inputs.

bf16 rounds at different points in the two packages (see `ops/norm.py`
and `ops/gather.py`: the port converts bf16 values to f32, computes a batch
norm's affine and activation, and a bilinear gather's weights and sums, in
f32 and rounds once; JAX rounds the folded affine and the bilinear weights
to bf16 and every op's result), so the two are not held to each other at f32
tolerances. Each module is held either to JAX's bf16 result within a few
bf16 spacings, or by error ratio: the port's bf16 error against JAX's f32
result must be at most RATIO times JAX's own bf16 error against it, on the
same weights. The whole step is held by its loss (within STEP_LOSS_RTOL of
JAX's bf16 loss) and its invariants, not per gradient leaf: JAX's own bf16
gradient leaves differ from its f32 ones by a median relative L2 of ~0.5 on
this preset, and the tiny batch's batch norms amplify the rounding.

Tolerances (each test states its own):
  BF16_REL_L2     relative L2 of a bf16 output, gradient or product against
                  JAX's bf16 one (measured up to 1.4e-2, a BN weight gradient)
  RATIO           port-bf16 error / JAX-bf16 error, both against an f32
                  reference (measured up to 1.28, the render's depth)
  STEP_LOSS_RTOL  the bf16 step's loss against JAX's bf16 loss (measured
                  3.4e-4; JAX's bf16 loss is 1.9e-3 from its f32 loss)
"""
import jax
import jax.numpy as jnp
import flax.linen as jnn
import numpy as np
import pytest
import torch

from _torch_parity import jax_sphere_maps, jax_variables, port_model, seeded_like
from scenerf_tpu import config as JC
from scenerf_tpu import fields as jfields
from scenerf_tpu import geometry as jgeo
from scenerf_tpu import sampling as JS
from scenerf_tpu.data.synthetic import make_batch as jax_make_batch
from scenerf_tpu.encoder.norm import FusedBatchNorm as JaxBatchNorm
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import fields
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.model import LEVEL_KEYS
from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.ops.composite import SomInputs, sort_composite
from scenerf_tpu_torch.ops.gather import gather_levels, share_pyramid_grads
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
BF16 = torch.bfloat16
KEY = jax.random.PRNGKey(0)
BF16_REL_L2 = 3e-2
RATIO = 2.0
STEP_LOSS_RTOL = 2e-3
ADAM_EPS = 1e-8
JAX_ACTS = {"identity": lambda z: z, "silu": jnn.swish, "leaky": jnn.leaky_relu}


def _np(t) -> np.ndarray:
    """A tensor or array as f64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: (torch bf16, jax bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ---------------------------------------------------------------- batch norm


@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_act_bf16_matches_jax(act, train):
    """The plain bf16 FusedBatchNorm + activation + residual (kernel K5's
    CPU path) against `jax.vjp` of JAX's FusedBatchNorm(dtype=bfloat16) +
    the activation, on the same bf16 x, residual and cotangent: y, dx,
    dweight, dbias and d_residual within BF16_REL_L2 of JAX's; y's error
    against the f32 op on the same values (the port's plain f32 version,
    held to JAX's f32 by test_torch_norm_act.py) within RATIO of JAX's, and
    within one bf16 rounding of it (the port rounds y once); the running
    statistics (f32 sums of the same bf16 values) rtol 1e-5."""
    rng = np.random.default_rng(3)
    shape = (2, 5, 7, 16)
    mom, eps = 0.9, 1e-5
    x_t, x_j = _bf16(rng.normal(size=shape) * 2 + 0.5)
    r_t, r_j = _bf16(rng.normal(size=shape))
    g_t, g_j = _bf16(rng.normal(size=shape))
    bn = JaxBatchNorm(use_running_average=not train, momentum=mom, epsilon=eps,
                      dtype=jnp.bfloat16)
    v = seeded_like(jax.eval_shape(bn.init, KEY, x_j), seed=4)

    def fn(params, xx, rr):
        z, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return JAX_ACTS[act](z + rr), upd

    want_y, vjp, upd = jax.vjp(fn, v["params"], x_j, r_j, has_aux=True)
    d_params, d_x, d_r = vjp(g_j)
    assert want_y.dtype == jnp.bfloat16

    def port_module():
        port = FusedBatchNorm(shape[-1], eps, mom, act=act)
        sd = {}
        W._bn(sd, "bn", v["params"], v["batch_stats"])
        port.load_state_dict({k[3:]: torch.from_numpy(np.asarray(a)) for k, a in sd.items()})
        return port.train(train)

    port = port_module()
    xl, rl = x_t.clone().requires_grad_(True), r_t.clone().requires_grad_(True)
    build.reset_launch_counts()
    y = port(xl, rl)
    y.backward(g_t)
    assert sum(build.LAUNCHES.values()) == 0
    assert y.dtype == BF16 and xl.grad.dtype == BF16 and rl.grad.dtype == BF16
    assert port.weight.grad.dtype == torch.float32 and port.running_mean.dtype == torch.float32
    with torch.no_grad():
        y32 = port_module()(x_t.float(), r_t.float())

    err_port, err_jax = _rel_l2(y, y32), _rel_l2(want_y, y32)
    one_rounding = np.abs(_np(y) - _np(y32)) <= 2.0 ** -8 * np.abs(_np(y32)) + 1e-6
    print(f"{act} train={train}: y vs JAX bf16 {_rel_l2(y, want_y):.2e}; vs f32: port "
          f"{err_port:.2e}, JAX {err_jax:.2e}; dx {_rel_l2(xl.grad, d_x):.2e}, dweight "
          f"{_rel_l2(port.weight.grad, d_params['scale']):.2e}")
    assert err_port <= RATIO * err_jax, (err_port, err_jax)
    assert one_rounding.all()
    for name, a, b in (("running_mean", port.running_mean, upd["batch_stats"]["mean"]),
                       ("running_var", port.running_var, upd["batch_stats"]["var"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7, err_msg=name)
    for name, a, b in (("y", y, want_y), ("dx", xl.grad, d_x),
                       ("dweight", port.weight.grad, d_params["scale"]),
                       ("dbias", port.bias.grad, d_params["bias"]), ("d_residual", rl.grad, d_r)):
        assert _rel_l2(a, b) <= BF16_REL_L2, (name, _rel_l2(a, b))


# ---------------------------------------------------------------- gather


@pytest.mark.parametrize("shared", [False, True])
def test_gather_bf16_matches_jax(shared):
    """The plain bf16 gather (kernel G's CPU path) and its VJP against
    `geometry.sample_feats_2d` on a bf16 level. JAX rounds the bilinear
    weights to bf16 and interpolates in bf16; the port does both in f32 and
    rounds each output once. Values within 2 bf16 spacings of max|level| of
    JAX's; each side's error against the f32 gather of the same level: the
    port's within RATIO of JAX's, and within half a spacing of each value
    (one rounding). The level gradient (f32 sums into the buffer, bf16 once;
    through a pyramid's shared buffers with `shared`) within BF16_REL_L2 of
    JAX's bf16 VJP; its dtype is the level's."""
    rng = np.random.default_rng(5)
    H, W_, Cn, N = 9, 13, 24, 400
    lv_t, lv_j = _bf16(rng.normal(size=(H, W_, Cn)))
    pix = (rng.uniform(-2, [W_ + 1, H + 1], size=(N, 2))).astype(np.float32)
    norm_wh = (W_, H)
    g_t, g_j = _bf16(rng.normal(size=(N, Cn)))
    want, vjp = jax.vjp(lambda f: jgeo.sample_feats_2d(f, jnp.asarray(pix), norm_wh), lv_j)
    d_lv_j, = vjp(g_j)
    ref = jgeo.sample_feats_2d(lv_j.astype(jnp.float32), jnp.asarray(pix), norm_wh)

    grid = geo.normalize_pix(torch.from_numpy(pix), norm_wh)
    ix, iy = geo.unnormalize_coords(grid, H, W_)
    leaf = lv_t.clone().requires_grad_(True)
    levels, grads = share_pyramid_grads([leaf]) if shared else ([leaf], None)
    got = gather_levels(levels, ix[None], iy[None], grads=grads)
    got.backward(g_t)
    assert got.dtype == BF16 and leaf.grad.dtype == BF16

    scale = float(np.abs(_np(lv_t)).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= 2 * 2.0 ** -7 * scale
    err_port, err_jax = _rel_l2(got, ref), _rel_l2(want, ref)
    one_rounding = np.abs(_np(got) - _np(ref)) <= 2.0 ** -8 * np.abs(_np(ref)) + 1e-30
    print(f"gather: port {err_port:.2e}, JAX {err_jax:.2e} rel L2 vs f32; grad rel L2 "
          f"{_rel_l2(leaf.grad, d_lv_j):.2e}")
    assert err_port <= RATIO * err_jax, (err_port, err_jax)
    assert one_rounding.all()
    assert _rel_l2(leaf.grad, d_lv_j) <= BF16_REL_L2


# ---------------------------------------------------------------- field MLP


@pytest.mark.parametrize("d_out", [4, 2])
def test_resnetfc_bf16_matches_jax(d_out):
    """ResnetFC(dtype=bf16): bf16 products of bf16-cast weights (`torch.matmul`
    in the port), bf16 output; within BF16_REL_L2 of JAX's bf16 output, and
    its error against JAX f32 within RATIO of JAX bf16's."""
    rng = np.random.default_rng(d_out)
    d_in, d_latent, n_blocks, d_hidden = 42, 62, 2, 32
    z_t, z_j = _bf16(rng.normal(size=(200, d_latent)))
    x = rng.normal(size=(200, d_in)).astype(np.float32)
    nets = {dt: jfields.ResnetFC(d_out=d_out, n_blocks=n_blocks, d_hidden=d_hidden, dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}
    params = seeded_like(jax.eval_shape(nets[jnp.float32].init, KEY, z_j, x), seed=d_out)
    # a zero-initialized fc_1 is the identity block: give it weights
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)
    want = {dt: net.apply(params, z_j, x) for dt, net in nets.items()}
    out = {}
    W._resnetfc(out, "mlp", params["params"])
    port = fields.ResnetFC(d_in, d_out, d_latent, n_blocks, d_hidden, BF16)
    port.load_state_dict({k[4:]: torch.from_numpy(np.asarray(v)) for k, v in out.items()})
    with torch.no_grad():
        got = port(z_t, torch.from_numpy(x))
    assert got.dtype == BF16 and want[jnp.bfloat16].dtype == jnp.bfloat16
    err_port, err_jax = _rel_l2(got, want[jnp.float32]), _rel_l2(want[jnp.bfloat16],
                                                                  want[jnp.float32])
    print(f"ResnetFC d_out={d_out}: vs JAX bf16 {_rel_l2(got, want[jnp.bfloat16]):.2e}; vs "
          f"JAX f32: port {err_port:.2e}, JAX bf16 {err_jax:.2e}")
    assert _rel_l2(got, want[jnp.bfloat16]) <= BF16_REL_L2
    assert err_port <= RATIO * err_jax


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def model_run():
    """JAX's tiny model in f32 and bf16 and the port's in bf16, on the same
    seeded weights, frame, sphere maps and render noise: the eval and
    train-mode encodes, one render chunk's depth and color (each package's
    render on its own eval encode), and JAX's bf16 training loss on the
    step's batch and draws. The JAX side runs in one jitted function per
    dtype."""
    import test_torch_train_step as ts

    jcfg = {dt: JC.tiny(compute_dtype=dt, remat_chunks=False, remat_encoder=False)
            for dt in ("float32", "bfloat16")}
    cfg = C.tiny(compute_dtype="bfloat16")
    jms = {dt: JaxSceneRF(c) for dt, c in jcfg.items()}
    variables = jax_variables(jms["float32"], seed=5)
    K = default_intrinsics(cfg)
    img = input_frame(cfg, seed=5)
    maps = jax_sphere_maps(jcfg["float32"], K)
    Wd, Hd = cfg.img_size
    gy, gx = np.meshgrid(np.arange(0, Hd, 4), np.arange(0, Wd, 4), indexing="ij")
    pix = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
    R = pix.shape[0]
    rkey = jax.random.PRNGKey(3)
    k_uni, k_gauss = jax.random.split(rkey)
    noise_uni = np.asarray(JS.row_noise(k_uni, R, cfg.n_pts_uni, R, 0))
    noise_gauss = np.asarray(JS.row_noise(k_gauss, R, cfg.n_pts_gauss, R, 0, dist="normal"))
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 0.5
    jbatch = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg["float32"]).items()}
    skey = jax.random.PRNGKey(21)

    def jax_side(jm, v, x, k, mp, p, b):
        lv_eval, _ = jm.encode(v, x, k, sphere_maps=mp)
        lv_train, _ = jm.encode(v, x, k, train=True, sphere_maps=mp)
        out = jm.render_rays(v, jm.pyramid_for_item(lv_eval, 0), k, jnp.asarray(T), p, rkey,
                             ray_chunk=R)
        loss, _, _ = jm.forward(v, b, skey, train=True)
        return lv_eval, lv_train, {"depth": out["depth"], "color": out["color"]}, loss

    want = {dt: jax.device_get(jax.jit(lambda *a, jm=jm: jax_side(jm, *a))(
        variables, jnp.asarray(img), jnp.asarray(K), maps, jnp.asarray(pix), jbatch))
        for dt, jm in jms.items()}

    model = port_model(cfg, variables)
    maps_t = {s: torch.from_numpy(np.array(m)) for s, m in maps.items()}
    img_t = torch.from_numpy(img)
    with torch.no_grad():
        lv_eval = model.encode(img_t, K, sphere_maps=maps_t)
        out = model.render_rays(model.pyramid_for_item(lv_eval, 0), torch.from_numpy(K),
                                torch.from_numpy(T), torch.from_numpy(pix), ray_chunk=R,
                                noise_uni=torch.from_numpy(noise_uni),
                                noise_gauss=torch.from_numpy(noise_gauss))
    model.train()
    with torch.no_grad():
        lv_train = model.encode(img_t, K, sphere_maps=maps_t)
    model.load_state_dict(port_model(cfg, variables).state_dict())  # statistics back
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=ts.STEPS_PER_EPOCH, model=model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = trainer.train_step(make_batch(cfg),
                                 noise=ts.jax_draws(jcfg["float32"], skey, 1, cfg.n_sources))
    got = {"eval": lv_eval, "train": lv_train, "render": out, "metrics": metrics,
           "trainer": trainer, "before": before}
    return want, got


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_encode_bf16_error_ratio(model_run, mode):
    """The bf16 encode (every conv, batch norm, resample and resize in bf16)
    in eval and train mode: every level bf16 of JAX's shape, its relative
    L2 error against JAX's f32 levels at most RATIO x JAX bf16's."""
    want, got = model_run
    i = {"eval": 0, "train": 1}[mode]
    for k in LEVEL_KEYS:
        lv = got[mode][k]
        ref, jbf = want["float32"][i][k], want["bfloat16"][i][k]
        assert lv.dtype == BF16 and tuple(lv.shape) == ref.shape, k
        err_port, err_jax = _rel_l2(lv, ref), _rel_l2(jbf, ref)
        print(f"{mode} {k}: port bf16 {err_port:.2e}, JAX bf16 {err_jax:.2e} vs JAX f32")
        assert err_port <= RATIO * err_jax, (k, err_port, err_jax)


@pytest.mark.parametrize("name", ["depth", "color"])
def test_render_chunk_bf16_error_ratio(model_run, name):
    """One render chunk (every 4th pixel of the tiny frame, one chunk) on
    each package's bf16 eval encode, with the same noise: f32 depth and
    color, their relative L2 error against JAX's f32 render at most RATIO x
    JAX bf16's."""
    want, got = model_run
    out = got["render"][name]
    ref, jbf = want["float32"][2][name], want["bfloat16"][2][name]
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert bool(torch.isfinite(out).all())
    err_port, err_jax = _rel_l2(out, ref), _rel_l2(jbf, ref)
    print(f"render {name}: port bf16 {err_port:.2e}, JAX bf16 {err_jax:.2e} vs JAX f32")
    assert err_port <= RATIO * err_jax, (err_port, err_jax)


def test_train_step_bf16(model_run):
    """One bf16 training step from the same weights, batch and draws as JAX's
    bf16 forward: the loss within STEP_LOSS_RTOL of JAX's bf16 loss; every
    metric f32 and finite; every parameter, gradient and BN statistic f32,
    the gradients finite; the first AdamW step moves each weight by -lr g /
    (|g| + eps) within 0.05 lr + one f32 spacing."""
    want, got = model_run
    metrics, trainer, before = got["metrics"], got["trainer"], got["before"]
    loss, jloss = float(metrics["total_loss"]), float(want["bfloat16"][3])
    print(f"bf16 step loss: port {loss:.6f}, JAX bf16 {jloss:.6f}, JAX f32 "
          f"{float(want['float32'][3]):.6f}")
    assert abs(loss - jloss) <= STEP_LOSS_RTOL * abs(jloss)
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v)), k
    assert {t.dtype for t in trainer.model.state_dict().values()} == {torch.float32}
    lr = trainer.lr_at(0)
    for k, p in trainer.model.named_parameters():
        g = p.grad
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        p0 = before[k]
        spacing = torch.nextafter(p0.abs(), torch.full_like(p0, float("inf"))) - p0.abs()
        err = ((p.detach() - p0) + lr * g / (g.abs() + ADAM_EPS)).abs() - spacing
        assert float(err.max()) <= 0.05 * lr, (k, float(err.max()) / lr)


def test_bf16_checkpoint_renders_in_bf16(tmp_path):
    """The reconstruction sweep runs in the checkpoint's compute dtype: a bf16
    model saved and loaded keeps its config (f32 weights), encodes to bf16
    levels and renders f32 depth and color."""
    from scenerf_tpu_torch.utils.checkpoint import load_model, save_checkpoint

    cfg = C.tiny(compute_dtype="bfloat16")
    torch.manual_seed(0)
    path = str(tmp_path / "model.pt")
    from scenerf_tpu_torch.model import SceneRF

    save_checkpoint(path, SceneRF(cfg))
    model = load_model(path, "cpu")
    assert model.cfg.compute_dtype == "bfloat16"
    K = default_intrinsics(cfg)
    lv = model.encode(torch.from_numpy(input_frame(cfg, seed=1)), K)
    assert {v.dtype for v in lv.values()} == {BF16}
    out = model.render_pose_sweep(model.pyramid_for_item(lv, 0), torch.from_numpy(K),
                                  torch.eye(4)[None], stride=8)
    assert out["depth"].dtype == out["color"].dtype == torch.float32
    assert bool(torch.isfinite(out["depth"]).all())


def test_bf16_into_f32_only_kernels_raises():
    """No quiet cast to f32: kernel C (sort + composite, with RaySOM's EM)
    takes f32 only, and one gather takes levels of one dtype; anything else
    raises, on the CPU path as on the card."""
    sd = torch.rand(3, 8)
    rgb = torch.rand(3, 8, 3)
    with pytest.raises(ValueError, match="f32"):
        sort_composite(sd, sd, sd.to(BF16), rgb)
    with pytest.raises(ValueError, match="f32"):
        sort_composite(sd, sd, sd, rgb, som=SomInputs(sd[:, :2], sd[:, :2].to(BF16), 2.0, 0.1))
    with pytest.raises(ValueError, match="one dtype"):
        gather_levels([torch.rand(4, 5, 8), torch.rand(4, 5, 8, dtype=BF16)],
                      torch.zeros(2, 3), torch.zeros(2, 3))


@pytest.fixture(scope="module")
def effnet_run():
    """A small EfficientNet (width 0.5, depth 0.4: every MBConv kind, 64
    features) on a 64x48 frame from the same seeded weights: JAX's taps in
    f32 and bf16 (one jitted eval + train-mode apply per dtype) and the
    port's bf16 taps, eval and train mode."""
    from scenerf_tpu.encoder.backbones import EfficientNet as JaxEfficientNet
    from scenerf_tpu_torch.encoder.backbones import EfficientNet

    x = np.random.default_rng(6).uniform(size=(1, 48, 64, 3)).astype(np.float32)
    nets = {dt: JaxEfficientNet(width=0.5, depth=0.4, num_features=64, remat=False, dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}
    v = seeded_like(jax.eval_shape(nets[jnp.float32].init, KEY, x), seed=2)

    def both(net, v, xx):
        train, _ = net.apply(v, xx, train=True, mutable=["batch_stats"])
        return net.apply(v, xx), train

    want = {dt: jax.device_get(jax.jit(lambda v, xx, net=net: both(net, v, xx))(
        v, jnp.asarray(x).astype(dt))) for dt, net in nets.items()}
    sd = {}
    W._backbone(sd, v["params"], v["batch_stats"])
    n = len(W.ENCODER) + 1
    state = {k[n:]: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()
             if k.startswith(W.ENCODER + ".")}
    got = []
    for train in (False, True):
        port = EfficientNet(width=0.5, depth=0.4, num_features=64, dtype=BF16)
        port.load_state_dict(state)
        with torch.no_grad():
            got.append(port.train(train)(torch.from_numpy(x).to(BF16)))
    return want, got


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_efficientnet_bf16_error_ratio(effnet_run, mode):
    """The bf16 EfficientNet (convs and the squeeze-excitation in bf16 over
    f32 weights, batch norms with swish fused, the projection BN with the
    block residual) against JAX's EfficientNet(dtype=bfloat16): every tap
    bf16, its relative L2 error against JAX f32 at most RATIO x JAX bf16's.
    In train mode the error grows with depth in both packages (measured on
    this net: 7e-3 at s2 to 0.26 at s32, JAX's 1e-2 to 0.46)."""
    want, got = effnet_run
    i = {"eval": 0, "train": 1}[mode]
    for k, ref in want[jnp.float32][i].items():
        tap = got[i][k]
        assert tap.dtype == BF16 and tuple(tap.shape) == ref.shape, k
        err_port, err_jax = _rel_l2(tap, ref), _rel_l2(want[jnp.bfloat16][i][k], ref)
        print(f"EfficientNet {mode} {k}: port bf16 {err_port:.2e}, JAX bf16 {err_jax:.2e}")
        assert err_port <= RATIO * err_jax, (k, err_port, err_jax)
