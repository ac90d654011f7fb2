"""Multi-rank execution of the PyTorch port (`scenerf_tpu_torch/parallel/`)
against the JAX package's mesh, on the CPU: two gloo processes
(tests/_torch_parallel_worker.py, spawned once for the module) against a
2-device mesh of the 8 virtual CPU devices tests/conftest.py sets up.

* Synced K5 (the plain stages, split at the reduction with the all-reduce
  between): y, the running statistics, dx, d_residual, and each rank's own
  dweight / dbias against `jax.vjp` of `FusedBatchNorm(axis_name=...)` + the
  activation under `shard_map`, per device (weight and bias mapped, so their
  cotangents are each device's own, before any gradient pmean), at
  test_torch_norm_act.py's tolerances (rtol 1e-5, atol 1e-6 of the largest).
* Data mode: the two-rank `tiny` step (one item a rank, batch norm synced)
  against JAX's 2-device step body (`scenerf_tpu/train.py:152-187`: the key
  folded with the step and the device index, value_and_grad, pmean of the
  gradients and metrics, BN synced by axis_name), the draws injected as
  test_torch_train_step.py injects them and at its tolerances (metrics rtol
  1e-3, leaves relative L2 <= 1e-3, running statistics rtol 1e-4); the two
  ranks' parameters after AdamW bit-equal.
* ray_shard: the two-rank step (depth eval on) against the port's one-rank
  step on the same item and draws, to f32 reduction order.
* ray_parallel: the ranks draw different pixels, and the averaged gradient
  is the mean of the two one-rank steps on those draws.
* The loader's slices against JAX's `DataLoader(process_index=,
  process_count=)`, element for element.
* Sharded renders: a 2-rank render of 300 LiDAR-like pixels (padded to 512:
  W x chunk) and a 2-pose sweep against the one-rank render, and against
  JAX's `make_sharded_renderer` on 2 devices fed the same levels and JAX's
  noise.
* The CLI in a world of two ranks: `--n_devices 3` and a `--bs` the world
  does not divide raise a UsageError naming the numbers.

Tolerances not inherited above are stated where they are used, with what
they measured.
"""
import multiprocessing
import os
import socket
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import flax.linen as jnn
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parity import jax_variables, seeded_like
from test_torch_train_step import jax_draws
from scenerf_tpu import config as JC
from scenerf_tpu import rendering as JR
from scenerf_tpu import sampling as JS
from scenerf_tpu.data.loader import DataLoader as JaxDataLoader
from scenerf_tpu.data.synthetic import make_batch as jax_make_batch
from scenerf_tpu.encoder.norm import FusedBatchNorm as JaxBatchNorm
from scenerf_tpu.model import SceneRF as JaxSceneRF
from scenerf_tpu.parallel.sharded_render import make_sharded_renderer as jax_sharded_renderer
from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.loader import DataLoader
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.utils import weights as W

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 13
BN_SHAPE = (4, 5, 7, 6)  # split on the first axis: 2 x 5 x 7 rows of 6 channels a rank
BN_CASES = [(act, res) for act in ("silu", "leaky") for res in (False, True)]
JAX_ACTS = {"silu": jnn.swish, "leaky": jnn.leaky_relu}
BN_MOM, BN_EPS = 0.99, 1e-3
N_PIX, CHUNK = 300, 128
SWEEP_STRIDE, SWEEP_POSES = 4, 2
RANK_TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bn_inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=BN_SHAPE) * 2 + 0.5).astype(np.float32)
    x[..., 0] = 0.5  # a constant channel: var 0 on both sides
    r = rng.normal(size=BN_SHAPE).astype(np.float32)
    g = rng.normal(size=BN_SHAPE).astype(np.float32)
    v = seeded_like(jax.eval_shape(JaxBatchNorm().init, jax.random.PRNGKey(0), x), seed=3)
    return x, r, g, v


def _jax_synced_bn(act, res, x, r, g, v):
    """JAX's FusedBatchNorm(axis_name) + act (+ r) under shard_map over 2
    devices, through jax.vjp: per-device outputs, updated statistics and
    cotangents (scale and bias tiled per device, so theirs are the
    device's own)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    bn = JaxBatchNorm(momentum=BN_MOM, epsilon=BN_EPS, axis_name="d")

    def per_device(scale, bias, xx, rr):
        z, upd = bn.apply({"params": {"scale": scale[0], "bias": bias[0]},
                           "batch_stats": v["batch_stats"]}, xx, mutable=["batch_stats"])
        y = JAX_ACTS[act](z + rr if res else z)
        return y, upd["batch_stats"]["mean"][None], upd["batch_stats"]["var"][None]

    fn = shard_map(per_device, mesh=mesh, in_specs=(P("d"),) * 4, out_specs=(P("d"),) * 3,
                   check_vma=False)
    tile = lambda a: jnp.tile(jnp.asarray(a)[None], (2, 1))  # noqa: E731

    @jax.jit
    def fwd_bwd(*args):
        (y, mean, var), vjp = jax.vjp(fn, *args[:4])
        return (y, mean, var), vjp((args[4], jnp.zeros_like(mean), jnp.zeros_like(var)))

    (y, mean, var), (ds, db, dx, dr) = fwd_bwd(
        tile(v["params"]["scale"]), tile(v["params"]["bias"]), jnp.asarray(x), jnp.asarray(r),
        jnp.asarray(g))
    return {k: np.asarray(a) for k, a in dict(y=y, mean=mean, var=var, dw=ds, db=db, dx=dx,
                                               dr=dr).items()}


def _jax_data_step(jcfg, variables, jbatch, key):
    """JAX's 2-device step body (scenerf_tpu/train.py:152-187) at step 0:
    (pmean'd metrics, the new batch statistics, pmean'd gradients)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jm = JaxSceneRF(jcfg, axis_name="data")
    params = {k: variables[k]["params"] for k in variables}
    stats = variables["net_rgb"]["batch_stats"]

    def per_shard(params, batch, key):
        key = jax.random.fold_in(jax.random.fold_in(key, 0), jax.lax.axis_index("data"))

        def loss_fn(p):
            v = {k: {"params": p[k]} for k in p}
            v["net_rgb"]["batch_stats"] = stats
            loss, metrics, new_v = jm.forward(v, batch, key, train=True)
            return loss, (metrics, new_v["net_rgb"]["batch_stats"])

        (_, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return (jax.lax.pmean(metrics, "data"), new_stats, jax.lax.pmean(grads, "data"))

    fn = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P(), P("data"), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    return jax.device_get(fn(params, {k: jnp.asarray(v) for k, v in jbatch.items()}, key))


def _jax_data_step_seeded():
    """`_jax_data_step` on the fixture's seeded weights, batch and key: run in
    a process of its own, so that the module's longest compile overlaps the
    rest of JAX's side."""
    from scenerf_tpu.utils.jax_setup import setup_compilation_cache

    setup_compilation_cache()
    jcfg = JC.tiny(remat_chunks=False, remat_encoder=False)
    return _jax_data_step(jcfg, jax_variables(JaxSceneRF(jcfg), seed=5),
                          jax_make_batch(jcfg, batch_size=2), jax.random.PRNGKey(21))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    jcfg = JC.tiny(remat_chunks=False, remat_encoder=False)
    cfg = C.tiny()
    variables = jax_variables(JaxSceneRF(jcfg), seed=5)
    sd = W.state_dict_from_jax_variables(variables)
    x, r, g, v = _bn_inputs()
    bn = [dict(act=act, res=res, mom=BN_MOM, eps=BN_EPS, x=x, r=r, g=g,
               scale=np.asarray(v["params"]["scale"]), bias=np.asarray(v["params"]["bias"]),
               mean=np.asarray(v["batch_stats"]["mean"]),
               var=np.asarray(v["batch_stats"]["var"])) for act, res in BN_CASES]
    key = jax.random.PRNGKey(21)
    noise_data = [jax_draws(jcfg, jax.random.fold_in(jax.random.fold_in(key, 0), dev), 1,
                            cfg.n_sources) for dev in range(2)]
    # the render: the port's levels (fed to both packages), JAX's noise over
    # the rays padded to W x chunk (JAX's eval pad_to)
    model = SceneRF(cfg).eval()
    model.load_state_dict(sd)
    img, K = input_frame(cfg, seed=6), default_intrinsics(cfg)
    with torch.no_grad():
        levels = model.encode(torch.from_numpy(img), K)
    rng = np.random.default_rng(7)
    Wd, H = cfg.img_size
    pixels = np.stack([rng.integers(0, Wd, N_PIX), rng.integers(0, H, N_PIX)], -1).astype(
        np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.2, -0.05, 0.4)
    rkey = jax.random.PRNGKey(8)
    n_pad = -(-N_PIX // (2 * CHUNK)) * 2 * CHUNK
    k_uni, k_gauss = jax.random.split(rkey)
    nu = np.array(JS.row_noise(k_uni, n_pad, cfg.n_pts_uni))[:N_PIX]
    ng = np.array(JS.row_noise(k_gauss, n_pad, cfg.n_pts_gauss, dist="normal"))[:N_PIX]
    poses = np.stack([np.eye(4, dtype=np.float32)] * SWEEP_POSES)
    poses[1, :3, 3] = (0.1, 0.0, 0.3)
    inputs = dict(state_dict=sd, seed=SEED, bn=bn, batch2=make_batch(cfg, batch_size=2),
                  batch1=make_batch(cfg), noise_data=noise_data,
                  render=dict(img=img, K=np.asarray(K, np.float32), T=T, pixels=pixels,
                              nu=nu, ng=ng, chunk=CHUNK, stride=SWEEP_STRIDE, poses=poses))
    torch.save(inputs, d / "inputs.pt")

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
                               str(d)], env=dict(env, RANK=str(k), LOCAL_RANK=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        # JAX's side while the ranks run, the data step in a process of its own
        data = pool.submit(_jax_data_step_seeded)
        want = dict(
            bn=[_jax_synced_bn(act, res, x, r, g, v) for act, res in BN_CASES],
            batch_equal=all(np.array_equal(a, b) for a, b in zip(
                jax_make_batch(jcfg, batch_size=2).values(), inputs["batch2"].values())))
        jm = JaxSceneRF(jcfg)
        jrender = jax_sharded_renderer(jm, Mesh(np.array(jax.devices()[:2]), ("data",)),
                                       ray_chunk=CHUNK)
        padded, _ = JR.pad_rays(jnp.asarray(pixels), 2 * CHUNK)
        jlevels = tuple(jnp.asarray(levels[k][0].numpy()) for k in
                        ("1_1", "1_2", "1_4", "1_8", "1_16"))
        out = jrender(variables, jlevels, jnp.asarray(K, jnp.float32), jnp.asarray(T), padded,
                      rkey)
        want["render"] = {k: np.asarray(out[k])[:N_PIX] for k in ("depth", "color")}
        want["data"] = data.result(timeout=RANK_TIMEOUT_S)
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        pool.shutdown(cancel_futures=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {k} exited {p.returncode}:\n{log}"
    got = [torch.load(d / f"rank{k}.pt", weights_only=False) for k in range(2)]
    return got, want, variables


def _close(got, want, what, rtol=1e-5, atol_rel=1e-6):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-3), err_msg=what)


def _leaves_close(got, want, bound):
    """Every leaf within relative L2 `bound`; a leaf whose reference is zero
    up to rounding (<= 1e-6 of the largest) within 1e-5 of the largest in
    absolute L2 (test_torch_train_step.py's rule). Returns the worst."""
    assert set(got) == set(want) and got
    scale = max(np.linalg.norm(w) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        assert got[k].shape == w.shape and np.isfinite(got[k]).all(), k
        diff = np.linalg.norm(got[k] - w)
        if np.linalg.norm(w) <= 1e-6 * scale:
            assert diff <= 1e-5 * scale, (k, diff, scale)
            continue
        worst = max(worst, diff / np.linalg.norm(w))
        assert diff / np.linalg.norm(w) <= bound, (k, diff / np.linalg.norm(w))
    return worst


def test_ranks_joined_over_gloo(run):
    got, _, _ = run
    assert [g["world"] for g in got] == [(0, 2, "gloo"), (1, 2, "gloo")]


@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_synced_bn_matches_jax(run, case):
    got, want, _ = run
    w = want["bn"][case]
    act, res = BN_CASES[case]
    half = BN_SHAPE[0] // 2
    for k in range(2):
        gk, sl = got[k]["bn"][case], slice(k * half, (k + 1) * half)
        what = f"{act}{' + residual' if res else ''} rank {k}"
        _close(gk["y"], w["y"][sl], f"y {what}")
        _close(gk["dx"], w["dx"][sl], f"dx {what}")
        _close(gk["mean"], w["mean"][k], f"running mean {what}")
        _close(gk["var"], w["var"][k], f"running var {what}")
        # channel 0 is constant (var 0): its dweight, sum g (x - mean) inv, is
        # 0 up to rounding; JAX's jitted pmean of the means lands a spacing off
        # 0.5 and leaves 2.3e-5 there (measured), the port's exact sums 0
        _close(gk["dw"][1:], w["dw"][k][1:], f"dweight {what}")
        assert abs(gk["dw"][0] - w["dw"][k][0]) <= 1e-4, (what, gk["dw"][0], w["dw"][k][0])
        _close(gk["db"], w["db"][k], f"dbias {what}")
        if res:
            _close(gk["dr"], w["dr"][sl], f"d_residual {what}")
    # the ranks' statistics are the world's: the running statistics agree
    np.testing.assert_array_equal(got[0]["bn"][case]["mean"], got[1]["bn"][case]["mean"])


def test_data_mode_matches_jax_two_device_step(run):
    got, want, variables = run
    assert want["batch_equal"]
    metrics, new_stats, grads = want["data"]
    for k in range(2):
        m = got[k]["data"]["metrics"]
        assert set(m) == set(metrics)
        for name, w in metrics.items():
            np.testing.assert_allclose(m[name], float(w), rtol=1e-3, atol=1e-6, err_msg=name)
    worst = _leaves_close(got[0]["data"]["grads"], W.numpy_grads_from_jax(grads), 1e-3)
    print(f"data mode, 2 ranks vs JAX's 2-device step: worst leaf relative L2 {worst:.3e}")
    updated = dict(variables)
    updated["net_rgb"] = {"params": variables["net_rgb"]["params"], "batch_stats": new_stats}
    stats = {k: v for k, v in W.numpy_state_dict_from_jax_variables(updated).items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats
    for k in range(2):
        for name, w in stats.items():
            np.testing.assert_allclose(got[k]["data"]["buffers"][name], w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-3), err_msg=name)


@pytest.mark.parametrize("mode", ["data", "ray_shard", "ray_parallel"])
def test_ranks_stay_bit_equal(run, mode):
    """The averaged gradients, AdamW's step and (data mode: synced) BN
    statistics leave both ranks with the same parameters and buffers."""
    got, _, _ = run
    for what in ("params", "buffers", "grads"):
        a, b = got[0][mode][what], got[1][mode][what]
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{what} {name}")


def test_ray_shard_equals_one_rank_step(run):
    """The split rays (and GT rows) against the unsplit step on the same item
    and draws: the loss means and the gradient sums add in another order
    (measured: metrics within 3e-7 relative, leaves within 2e-6 relative
    L2), held at 1e-5 and 1e-4."""
    got, _, _ = run
    ref, sh = got[0]["ref_ray_shard"], got[0]["ray_shard"]
    assert "depth/abs_rel" in sh["metrics"] and set(sh["metrics"]) == set(ref["metrics"])
    for name, w in ref["metrics"].items():
        np.testing.assert_allclose(sh["metrics"][name], w, rtol=1e-5, atol=1e-7, err_msg=name)
    worst = _leaves_close(sh["grads"], ref["grads"], 1e-4)
    print(f"ray_shard vs one rank: worst leaf relative L2 {worst:.3e}")
    for name, w in ref["buffers"].items():
        np.testing.assert_allclose(sh["buffers"][name], w, rtol=1e-6, err_msg=name)


def test_ray_parallel_is_mean_of_one_rank_steps(run):
    """Each rank's own draws; the averaged gradient is the mean of the two
    one-rank steps on them (two f32 gradients added and halved: held at
    1e-5 relative L2)."""
    got, _, _ = run
    assert not np.array_equal(got[0]["ray_parallel"]["pixels"],
                              got[1]["ray_parallel"]["pixels"])
    refs = [got[k]["ref_ray_parallel"] for k in range(2)]
    mean = {k: (refs[0]["grads"][k] + refs[1]["grads"][k]) / 2 for k in refs[0]["grads"]}
    worst = _leaves_close(got[0]["ray_parallel"]["grads"], mean, 1e-5)
    print(f"ray_parallel vs the mean of two one-rank steps: worst {worst:.3e}")
    for name in refs[0]["metrics"]:
        np.testing.assert_allclose(got[0]["ray_parallel"]["metrics"][name],
                                   (refs[0]["metrics"][name] + refs[1]["metrics"][name]) / 2,
                                   rtol=1e-5, atol=1e-7, err_msg=name)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i]), "x": np.full((2,), i * 0.5, np.float32)}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


@pytest.mark.parametrize("count,bs,limit", [(2, 4, 0.5), (4, 4, 1.0), (2, 2, 1.0)])
def test_loader_slices_match_jax(count, bs, limit):
    ds = _Items(23)
    for rank in range(count):
        kw = dict(batch_size=bs, shuffle=True, limit_fraction=limit, seed=5,
                  process_index=rank, process_count=count)
        ours, theirs = DataLoader(ds, _collate, **kw), JaxDataLoader(ds, _collate, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):  # two epochs: the shuffle is drawn alike
            a, b = list(ours), list(theirs)
            assert len(a) == len(b) == len(ours)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ds, _collate, batch_size=3, process_count=2)


def test_sharded_render_matches_one_rank_and_jax(run):
    """2 ranks, 300 rays padded to 512 (256 a rank in chunks of 128): against
    JAX's 2-device renderer on the same levels and noise at rtol 1e-3 (the
    bar of test_torch_eval_cli.py's render); against the one-rank render and
    sweep from the same generator, within 1e-5 (only the padded last chunk's
    products differ in batch)."""
    got, want, _ = run
    rd = got[0]["render"]
    assert all(got[1]["render"][k] is None for k in ("jax_noise", "generator", "sweep"))
    for k in ("depth", "color"):
        assert rd["jax_noise"][k].shape[0] == N_PIX
        np.testing.assert_allclose(rd["jax_noise"][k], want["render"][k], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(rd["generator"][k], rd["one_generator"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert rd["sweep"][k].shape[:3] == rd["one_sweep"][k].shape[:3] == (
            SWEEP_POSES, 12, 16)
        np.testing.assert_allclose(rd["sweep"][k], rd["one_sweep"][k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name,needle", [
    ("save-depth-metrics", "the world has 2 ranks"),
    ("generate-novel-depths-bf", "the world has 2 ranks"),
    ("train-kitti", "do not divide --bs 3")])
def test_cli_refuses_what_the_world_cannot_take(run, name, needle):
    got, _, _ = run
    for k in range(2):
        code, output = got[k]["cli"][name]
        assert code == 2 and needle in output, output
