"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the edge cases the KITTI-shaped smoke run does not reach: the scalar
channel loop (the `tiny` levels, a misaligned level), out-of-bounds coords,
fewer than 64 samples per ray, tied distances, the `tiny` serve path on
the card against the same path on the CPU, and the evaluation render at a
source's LiDAR pixels (f32 and bf16) against the plain versions on the
card. The backward kernels (G-bwd, C-bwd) against autograd of the plain
versions: a misaligned level, corners off the map, a small level every point
lands on (atomic contention), saturated alphas; kernel S with argmax ties;
kernel C's training launch with RaySOM's EM inside (C = 1, 4, 8) against
the plain pair and C-bwd through its sort order, at every block size;
outputs that carry a `grad_fn` on the card; and the `tiny` training step
on the card against the CPU, also as `run_training` on a small KITTI tree
and at the BundleFusion preset's loss and sampling fields on a small
BundleFusion tree.
Kernel G bit-equal
at one level of every KITTI tap width and lane-group size; G-bwd's vector
and scalar atomics, its run-merging mapping, and a training step's chunk
gathers adding into one pyramid's shared buffers. Kernel T (TSDF
integrate) in both modes: one frame, ties on `>=`, voxels behind the camera
and on its z = 0 plane, pixels at the image border and on .5 boundaries and
an ulp either side of them, 63 frames at the KITTI grid, a grid whose axes
are no multiple of the kernel's tile under 1 and 63 KITTI sweep poses,
frames the kernel culls for every tile (out of view, behind), volumes that
start 4-12 B past a 16-B boundary, BundleFusion's grid under its 33-pose
sweep; bit-equal to the plain version but for voxels at a pixel-rounding
tie (at most 0.01% of the grid); its plan's constants equal to those of
the plain twin in ops/tsdf.py; marching cubes of a
volume the card fused at the BundleFusion grid. Kernel K5 (N1-N4:
batch norm + activation + residual) against the plain version and its
autograd in train and eval mode: C in {2, 3, 80, 3840}, M from 1 to 678,000,
a constant channel, every activation with and without the residual, the
vector and scalar paths, a directional derivative of its autograd.Function,
and the launch counts; its synced path (split at the reductions) at a world
of one rank bit-equal to the streaming kernels.

Marked `cuda`: skipped where no CUDA device is present (a CUDA kernel has no
CPU mode). The package under test imports no JAX, and neither does this
file, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.ops import composite as CM
from scenerf_tpu_torch.ops import gather as G
from scenerf_tpu_torch.ops import norm as N
from scenerf_tpu_torch.ops.composite import sort_composite, sort_composite_plain
from scenerf_tpu_torch.ops.gather import gather_levels, gather_levels_plain
from scenerf_tpu_torch.ops.tsdf import integrate, integrate_plain, pixel_ties
from scenerf_tpu_torch.som import som_em, som_em_plain
from scenerf_tpu_torch.train import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _coords(g, levels, n, dev):
    ix = torch.stack([torch.rand(n, generator=g, device=dev) * (lv.shape[1] + 4) - 2.5
                      for lv in levels])
    iy = torch.stack([torch.rand(n, generator=g, device=dev) * (lv.shape[0] + 4) - 2.5
                      for lv in levels])
    return ix, iy


@pytest.mark.parametrize("widths", [(2, 4, 8, 16, 32), (80, 160, 320, 640, 1280), (3,),
                                    (5, 12, 7)])
def test_gather_kernel_matches_plain(dev, widths):
    g = torch.Generator(device=dev).manual_seed(len(widths))
    levels = [torch.randn(9 + i, 13 + 2 * i, c, generator=g, device=dev)
              for i, c in enumerate(widths)]
    ix, iy = _coords(g, levels, 1000, dev)
    got = gather_levels(levels, ix, iy)
    want = gather_levels_plain(levels, ix, iy)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [40000, 700])
@pytest.mark.parametrize("width", [3, 8, 32, 48, 80, 224])
def test_gather_kernel_bit_equal_at_one_level(dev, width, n):
    """One level per call, as the sphere resamples launch it: at 40,000
    points with 1, 2, 8, 16, 32, 32 lanes per point, at 700 with the lane
    groups widened to 32 (the reprojection gather's case); G bit-equal to the
    plain version, coords off the map, huge and NaN (a NaN weight gives NaN
    on both) included."""
    g = torch.Generator(device=dev).manual_seed(width)
    level = torch.randn(23, 31, width, generator=g, device=dev)
    ix, iy = _coords(g, [level], n, dev)
    ix[0, :5] = torch.tensor([float("nan"), 1e30, -1e30, 3e9, -0.5])
    iy[0, 5:8] = torch.tensor([float("nan"), 1e30, 22.5])
    want_lanes = {3: 1, 8: 2, 32: 8, 48: 16}.get(width, 32) if n == 40000 else 32
    assert G.lanes_per_point([width], n) == want_lanes
    got = gather_levels([level], ix, iy)
    want = gather_levels_plain([level], ix, iy)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isfinite(got[8:]).all())


def test_gather_kernel_misaligned_level(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn(1 + 6 * 7 * 8, generator=g, device=dev)
    level = buf[1:].view(6, 7, 8)  # contiguous, but 4 bytes off 16-byte alignment
    ix, iy = _coords(g, [level], 300, dev)
    torch.testing.assert_close(gather_levels([level], ix, iy),
                               gather_levels_plain([level], ix, iy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("R", [1, 7, 300, 777, 1024, 5000])
@pytest.mark.parametrize("P", [1, 20, 33, 64])
def test_sort_composite_kernel_matches_plain(dev, P, R):
    """At the training (300), GT-depth (1024) and serve (5000) launch sizes
    and at sizes that leave a block part empty (1, 7, 777)."""
    g = torch.Generator(device=dev).manual_seed(P)
    sd = torch.clamp(torch.rand(R, P, generator=g, device=dev) * 120 - 20, min=0.1)  # ties
    dv = sd * 0.9
    dens = torch.rand(R, P, generator=g, device=dev) * 2
    rgb = torch.rand(R, P, 3, generator=g, device=dev)
    got = sort_composite(sd, dv, dens, rgb)
    want = sort_composite_plain(sd, dv, dens, rgb)
    torch.cuda.synchronize()
    for k in ("sensor_distance", "depth_volume"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for k in ("depth", "color", "alphas", "weights", "weights_at_depth",
              "closest_pts_to_depth"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert (got["closest_idx"] == want["closest_idx"]).float().mean() >= 0.999


def test_launch_counts_and_plain_versions(dev):
    lv = torch.randn(4, 5, 8, device=dev)
    xy = torch.zeros(1, 10, device=dev)
    sd = torch.rand(3, 8, device=dev)
    build.reset_launch_counts()
    gather_levels([lv], xy, xy)
    sort_composite(sd, sd, sd, torch.rand(3, 8, 3, device=dev))
    want = {k: 0 for k in build.LAUNCHES}
    want.update(gather_levels=1, sort_composite=1)
    assert build.LAUNCHES == want
    with build.plain_versions():
        gather_levels([lv], xy, xy)
        sort_composite(sd, sd, sd, torch.rand(3, 8, 3, device=dev))
        som_em(sd[:, :2], sd[:, :2] + 1, sd, sd, 2.0, 0.1)
    assert build.LAUNCHES == want
    with pytest.raises(ValueError, match="at most 64"):
        sort_composite(torch.rand(2, 65, device=dev), torch.rand(2, 65, device=dev),
                       torch.rand(2, 65, device=dev), torch.rand(2, 65, 3, device=dev))


def test_tiny_serve_on_card_matches_cpu(dev):
    cfg = C.tiny()
    torch.manual_seed(0)
    model = SceneRF(cfg).eval()
    K = default_intrinsics(cfg)
    img = torch.from_numpy(input_frame(cfg, seed=2))
    poses = torch.from_numpy(geo.rel_pose_stack(geo.sample_rel_poses(0.5, 10.0, 1.1)))
    cpu_lv = model.encode(img, K)
    cpu = model.render_pose_sweep(model.pyramid_for_item(cpu_lv, 0), torch.from_numpy(K),
                                  poses, seed=3, stride=2, ray_chunk=100)
    model.to(dev)
    build.reset_launch_counts()
    lv = model.encode(img.to(dev), K)
    pyramid = model.pyramid_for_item(lv, 0)
    pixels, _ = model._strided_pixels(2, dev)
    n_rays = pixels.shape[0]
    # the same noise as the CPU run: draw it on the CPU, render each pose on the card
    for p in range(poses.shape[0]):
        gen = torch.Generator().manual_seed(3 + p)
        nu = torch.rand(n_rays, cfg.n_pts_uni, generator=gen)
        ng = torch.randn(n_rays, cfg.n_pts_gauss, generator=gen)
        with torch.no_grad():
            out = model.render_rays(pyramid, torch.from_numpy(K).to(dev), poses[p].to(dev),
                                    pixels, ray_chunk=100, noise_uni=nu.to(dev),
                                    noise_gauss=ng.to(dev))
        for k in ("depth", "color"):
            want = cpu[k][p].reshape(out[k].shape)
            close = torch.isclose(out[k].cpu(), want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))
            assert close.reshape(close.shape[0], -1).all(1).float().mean() >= 0.99, (p, k)
    for k in ("1_1", "1_16"):
        torch.testing.assert_close(lv[k].cpu(), cpu_lv[k], rtol=1e-4, atol=1e-4)
    assert build.LAUNCHES["gather_levels"] > 0 and build.LAUNCHES["sort_composite"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_render_at_lidar_pixels_matches_plain(dev, dtype):
    """`save-depth-metrics`' render at a source's LiDAR pixels (an encode,
    then chunks of 128 with a ragged last one): kernels G, C and N2 against
    their plain versions on the card, >= 99% of rays within rtol 1e-3 (the
    serve path's and chip_smoke.py phase 15's check)."""
    from scenerf_tpu_torch.cli.evaluation import render_depth_at_pixels

    cfg = C.tiny(img_size=(1220, 370), compute_dtype=dtype)
    torch.manual_seed(0)
    model = SceneRF(cfg).to(dev).eval()
    K = default_intrinsics(cfg)
    img = torch.from_numpy(input_frame(cfg, seed=2)).to(dev)
    g = torch.Generator().manual_seed(1)
    pixels = torch.stack([torch.randint(0, 1220, (300,), generator=g),
                          torch.randint(150, 370, (300,), generator=g)], -1).float().numpy()
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 1.0
    out = {}
    for plain in (False, True):
        build.reset_launch_counts()
        with build.plain_versions() if plain else contextlib.nullcontext():
            pyramid = model.pyramid_for_item(model.encode(img, K), 0)
            out[plain] = render_depth_at_pixels(model, pyramid, K, T, pixels, 128,
                                                torch.Generator(device=dev).manual_seed(3))
        launches = dict(build.LAUNCHES)
        if not plain:
            assert launches["gather_levels"] >= 2 * 3 and launches["sort_composite"] == 3
            assert launches["bn_apply"] > 0 and launches["bn_stats"] == 0
        else:
            assert sum(launches.values()) == 0
    for i, name in enumerate(("depth", "color")):
        got, want = out[False][i], out[True][i]
        assert np.isfinite(got).all()
        close = np.isclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
        assert close.reshape(len(close), -1).all(1).mean() >= 0.99, name


# ------------------------------------------------------------- backwards


def _gather_grads(levels, ix, iy, d_out, plain: bool):
    lvs = [lv.detach().clone().requires_grad_(True) for lv in levels]
    x = ix.detach().clone().requires_grad_(True)
    y = iy.detach().clone().requires_grad_(True)
    out = (gather_levels_plain if plain else gather_levels)(lvs, x, y)
    out.backward(d_out)
    return [lv.grad for lv in lvs], x.grad, y.grad, out


@pytest.mark.parametrize("case", ["pyramid", "tiny", "image", "contended"])
def test_gather_bwd_kernel_matches_plain(dev, case):
    """d_levels (atomics: compared by tolerance) and, where the coords need
    them, d_ix/d_iy, against autograd of the plain version."""
    g = torch.Generator(device=dev).manual_seed(7)
    widths = {"pyramid": (80, 160, 320, 640, 1280), "tiny": (2, 4, 8, 16, 32),
              "image": (3,), "contended": (1280,)}[case]
    if case == "contended":  # a 3x4 level that all 20000 points land on
        levels = [torch.randn(3, 4, 1280, generator=g, device=dev)]
        n = 20000
    else:
        levels = [torch.randn(9 + i, 13 + 2 * i, c, generator=g, device=dev)
                  for i, c in enumerate(widths)]
        n = 1500
    ix, iy = _coords(g, levels, n, dev)
    d_out = torch.randn(n, sum(widths), generator=g, device=dev)
    build.reset_launch_counts()
    got_lv, got_x, got_y, got_out = _gather_grads(levels, ix, iy, d_out, plain=False)
    want_lv, want_x, want_y, want_out = _gather_grads(levels, ix, iy, d_out, plain=True)
    torch.cuda.synchronize()
    assert got_out.grad_fn is not None
    assert build.LAUNCHES["gather_levels_bwd"] == 1
    for a, b in zip(got_lv, want_lv):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    for a, b in ((got_x, want_x), (got_y, want_y)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


def test_gather_bwd_misaligned_level_and_no_coord_grad(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randn(1 + 6 * 7 * 8, generator=g, device=dev)
    ix, iy = _coords(g, [buf[1:].view(6, 7, 8)], 400, dev)
    d_out = torch.randn(400, 8, generator=g, device=dev)
    grads = []
    for fn in (gather_levels, gather_levels_plain):
        # contiguous, but 4 bytes off 16-byte alignment
        x = buf[1:].view(6, 7, 8).detach().requires_grad_(True)
        fn([x], ix, iy).backward(d_out)
        grads.append(x.grad)
    torch.cuda.synchronize()
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    assert ix.grad is None and iy.grad is None


@pytest.mark.parametrize("path", ["vector", "scalar"])
@pytest.mark.parametrize("width", [8, 48, 224])
def test_gather_bwd_vector_and_scalar_atomics(dev, path, width):
    """G-bwd's vector-atomic path (16-byte aligned level, gradient and
    cotangent: red.global.add.v4.f32) and its scalar path (the same level
    4 bytes off alignment), both against autograd of the plain version, with
    coordinate gradients; the kernel adds into the gradient it is given."""
    g = torch.Generator(device=dev).manual_seed(width)
    shape = (17, 29, width)
    n_el = shape[0] * shape[1] * width
    off = 0 if path == "vector" else 1
    lv_buf = torch.randn(n_el + 1, generator=g, device=dev)
    level = lv_buf[off:off + n_el].view(shape)
    n = 40001  # lanes per point 2, 16, 32
    ix, iy = _coords(g, [level], n, dev)
    d_out = torch.randn(n, width, generator=g, device=dev)
    start = torch.randn(shape, generator=g, device=dev)
    grad_buf = torch.zeros(n_el + 1, device=dev)
    grad = grad_buf[off:off + n_el].view(shape)
    grad.copy_(start)
    build.reset_launch_counts()
    d_ix, d_iy = G.gather_levels_backward([level], ix, iy, d_out, [grad], True)
    want = _gather_grads([level], ix, iy, d_out, plain=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["gather_levels_bwd"] == 1
    torch.testing.assert_close(grad - start, want[0][0], rtol=1e-5,
                               atol=1e-5 * float(want[0][0].abs().max()))
    for a, b in ((d_ix, want[1]), (d_iy, want[2])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("n", [1, 31, 2001])
def test_gather_bwd_run_merging(dev, n):
    """KITTI widths without a coordinate gradient: at 2001 points the
    run-merging mapping (runs of points in one cell, a run across a tile's
    end, points off the map and half off it, a tile cut short), at 1 and 31
    points too few warps for it and the per-point mapping; against autograd
    of the plain version."""
    g = torch.Generator(device=dev).manual_seed(n)
    widths = (80, 160, 320, 640, 1280)
    levels = [torch.randn(6 + 3 * i, 9 + 4 * i, c, generator=g, device=dev)
              for i, c in enumerate(widths)]
    ix, iy = _coords(g, levels, n, dev)
    run = torch.arange(n, device=dev) // 5  # five consecutive points a cell
    ix[:, : n // 2] = (run[: n // 2] % 4).float() + 0.3 + ix[:, : n // 2] % 0.5
    iy[:, : n // 2] = 1.25
    ix[:, n // 2::7] = -0.5  # half off the map
    ix[:, n // 2 + 1::7] = 1e9  # off the map
    d_out = torch.randn(n, sum(widths), generator=g, device=dev)
    grads = [torch.zeros_like(lv) for lv in levels]
    assert G.lanes_per_point(widths, n) == 32
    G.gather_levels_backward(levels, ix, iy, d_out, grads, False)
    want = _gather_grads(levels, ix, iy, d_out, plain=True)[0]
    torch.cuda.synchronize()
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_gather_bwd_chunks_accumulate_into_shared_pyramid_grads(dev):
    """A training-style sequence on one KITTI-width pyramid: chunk gathers of
    samples and anchors through `share_pyramid_grads` (one with no loss, one
    under no_grad) against autograd of the plain gathers, summed; the
    pyramid's buffers are zeroed once and the gathers' backwards return no
    level gradient."""
    g = torch.Generator(device=dev).manual_seed(11)
    widths = (80, 160, 320, 640, 1280)
    levels = [torch.randn(9 + 4 * i, 13 + 6 * i, c, generator=g, device=dev)
              for i, c in enumerate(widths)]
    chunks = [_coords(g, levels, n, dev) for n in (1920, 120, 1920, 120, 700, 64)]
    cots = [torch.randn(c[0].shape[1], sum(widths), generator=g, device=dev) for c in chunks]
    results = []
    for shared in (True, False):
        leaves = [lv.clone().requires_grad_(True) for lv in levels]
        pyramid, grads = G.share_pyramid_grads(leaves) if shared else (leaves, None)
        build.reset_launch_counts()
        loss = 0.0
        for i, (ix, iy) in enumerate(chunks):
            fn = gather_levels if shared else gather_levels_plain
            if i == 5:
                with torch.no_grad():
                    fn(pyramid, ix, iy, grads=grads) if shared else fn(pyramid, ix, iy)
                continue
            out = fn(pyramid, ix, iy, grads=grads) if shared else fn(pyramid, ix, iy)
            if i != 4:
                loss = loss + (out * cots[i]).sum()
        loss.backward()
        torch.cuda.synchronize()
        if shared:
            assert build.LAUNCHES["gather_levels"] == 6
            assert build.LAUNCHES["gather_levels_bwd"] == 4
            assert grads.buffers.take() is None
        results.append([lv.grad for lv in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _composite_inputs(g, R, P, dev, saturate: bool):
    sd = torch.clamp(torch.rand(R, P, generator=g, device=dev) * 120 - 20, min=0.1)  # ties
    dv = sd * 0.9
    dens = torch.rand(R, P, generator=g, device=dev) * 2
    if saturate:  # alpha rounds to 1 on about a third of the samples
        hot = torch.rand(R, P, generator=g, device=dev) < 0.33
        dens = torch.where(hot, dens * 100 + 50, dens)
    rgb = torch.rand(R, P, 3, generator=g, device=dev)
    return [sd, dv, dens, rgb]


@pytest.mark.parametrize("P", [1, 20, 33, 64])
@pytest.mark.parametrize("saturate", [False, True])
def test_sort_composite_bwd_kernel_matches_plain(dev, P, saturate):
    g = torch.Generator(device=dev).manual_seed(P)
    R = 777
    ins = _composite_inputs(g, R, P, dev, saturate)
    gd = torch.randn(R, generator=g, device=dev)
    gc = torch.randn(R, 3, generator=g, device=dev)
    grads = []
    for fn in (sort_composite, sort_composite_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        torch.autograd.backward([out["depth"], out["color"]], [gd, gc])
        grads.append([t.grad for t in leaves])
        if fn is sort_composite:
            assert out["depth"].grad_fn is not None and out["color"].grad_fn is not None
            assert out["alphas"].grad_fn is None
    torch.cuda.synchronize()
    for name, a, b in zip(("d_sd", "d_dv", "d_density", "d_rgb"), *grads):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1e-6),
                                   msg=name)


def _som_inputs(g, R, C_, dev):
    """Sorted means with equal prototypes (exact argmax ties) on a quarter
    of the rays, and stds."""
    means = torch.sort(torch.rand(R, C_, generator=g, device=dev) * 100, dim=1).values
    if C_ > 1:
        means[: (R + 3) // 4, 1] = means[: (R + 3) // 4, 0]
    stds = torch.rand(R, C_, generator=g, device=dev) * 4 + 1.5
    return means, stds


@pytest.mark.parametrize("R", [1, 7, 300, 1024, 5000])
@pytest.mark.parametrize("P", [1, 20, 33, 64])
def test_sort_composite_with_som_matches_plain(dev, P, R):
    """Kernel C's training launch, with RaySOM's EM inside, at C = 1, 4, 8:
    its composite outputs equal kernel C's alone (the sorted ones bit-equal
    to the stable sort), its EM outputs agree with `som_em_plain` on its
    sorted samples and alphas (all but 0.1% of the rays, rounded down, within
    rtol 1e-4, the mask equal), it counts one launch of C and one of S, and
    C-bwd through its `order` matches autograd of the plain version; with
    saturated alphas, clamped distance ties and equal prototypes."""
    g = torch.Generator(device=dev).manual_seed(R * 100 + P)
    ins = _composite_inputs(g, R, P, dev, saturate=True)
    alone = sort_composite(*ins)
    plain = sort_composite_plain(*ins)
    gd = torch.randn(R, generator=g, device=dev)
    gc = torch.randn(R, 3, generator=g, device=dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    out = sort_composite_plain(*leaves)
    want_grads = torch.autograd.grad([out["depth"], out["color"]], leaves, [gd, gc])
    for C_ in (1, 4, 8):
        means, stds = _som_inputs(g, R, C_, dev)
        som = CM.SomInputs(means, stds, 2.0, 0.1)
        build.reset_launch_counts()
        got = sort_composite(*ins, som=som)
        assert build.LAUNCHES["sort_composite"] == 1 and build.LAUNCHES["ray_som"] == 1
        assert build.LAUNCHES["ray_som_in_sort_composite"] == 1
        for k in CM._OUT_KEYS:
            torch.testing.assert_close(got[k], alone[k], rtol=0, atol=0, msg=k)
        for k in ("sensor_distance", "depth_volume"):
            torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
        em = som_em_plain(means, stds, got["sensor_distance"], got["alphas"], 2.0, 0.1)
        close = torch.ones(R, dtype=torch.bool, device=dev)
        for k, b in zip(CM.SOM_KEYS[:2], em[:2]):
            close &= torch.isclose(got[k], b, rtol=1e-4, atol=1e-4).all(dim=1)
        close &= (got["som_mask"] == em[2]).all(dim=1)
        assert int((~close).sum()) <= R // 1000, (C_, int((~close).sum()))

        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        out = sort_composite(*leaves, som=som)
        assert out["som_new_means"].grad_fn is None and out["depth"].grad_fn is not None
        grads = torch.autograd.grad([out["depth"], out["color"]], leaves, [gd, gc])
        torch.cuda.synchronize()
        for name, a, b in zip(("d_sd", "d_dv", "d_density", "d_rgb"), grads, want_grads):
            assert bool(torch.isfinite(a).all()), name
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * max(float(b.abs().max()), 1e-6), msg=name)


def test_ray_som_kernel_matches_plain_with_ties(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    R, C_, P = 2000, 4, 64
    means = torch.sort(torch.rand(R, C_, generator=g, device=dev) * 100, dim=1).values
    means[:200, 1] = means[:200, 0]  # equal prototypes: exact argmax ties
    stds = torch.rand(R, C_, generator=g, device=dev) * 4 + 1.5
    sd = torch.sort(torch.rand(R, P, generator=g, device=dev) * 100, dim=1).values
    alphas = torch.rand(R, P, generator=g, device=dev)
    build.reset_launch_counts()
    got = som_em(means, stds, sd, alphas, 2.0, 0.1)
    want = som_em_plain(means, stds, sd, alphas, 2.0, 0.1)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ray_som"] == 1
    close = torch.ones(R, dtype=torch.bool, device=dev)
    for a, b in zip(got[:2], want[:2]):
        close &= torch.isclose(a, b, rtol=1e-4, atol=1e-4).all(dim=1)
    close &= (got[2] == want[2]).all(dim=1)
    assert float(close.float().mean()) >= 0.999, float(close.float().mean())


def test_tiny_train_step_on_card_matches_cpu(dev):
    """One training step of the `tiny` model on the card (every kernel of the path)
    against the same step on the CPU (the plain versions): loss and metrics
    rtol 1e-3, every gradient relative L2 <= 1e-2 (leaves that are zero up to
    rounding: absolute, against the largest leaf); the gradient reaches the
    pyramid (the decoder) and the Gaussian heads."""
    cfg = C.tiny()
    torch.manual_seed(0)
    model = SceneRF(cfg)
    cpu = Trainer(cfg, device="cpu", model=model)
    card = Trainer(cfg, device=dev, model=SceneRF(cfg))
    card.model.load_state_dict(model.state_dict())
    batch = make_batch(cfg, seed=1)
    noise = model.draw_noise(1, cfg.n_sources, torch.Generator().manual_seed(4), "cpu")
    build.reset_launch_counts()
    got = card.train_step(batch, noise={k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    train_kernels = ("gather_levels", "gather_levels_bwd", "sort_composite",
                     "sort_composite_bwd", "ray_som", "bn_stats", "bn_apply", "bn_bwd_reduce",
                     "bn_bwd_apply")
    assert all(build.LAUNCHES[k] >= 1 for k in train_kernels), build.LAUNCHES
    # RaySOM's EM ran inside kernel C's training launches only: no launch of S alone
    assert build.LAUNCHES["ray_som"] == build.LAUNCHES["ray_som_in_sort_composite"]
    want = cpu.train_step(batch, noise=noise)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-5, msg=k)
    card_grads = dict(card.model.named_parameters())
    scale = max(float(p.grad.norm()) for p in cpu.model.parameters())
    for name, p in cpu.model.named_parameters():
        a, b = card_grads[name].grad.cpu(), p.grad
        diff = float((a - b).norm())
        if float(b.norm()) <= 1e-6 * scale:  # zero up to rounding (conv bias before a BN)
            assert diff <= 1e-5 * scale, (name, diff, scale)
        else:
            assert diff <= 1e-2 * float(b.norm()), (name, diff / float(b.norm()))
    for prefix in ("net_rgb.decoder.up1", "mlp_gaussian.lin_in", "mlp_gaussian.lin_z.0"):
        assert any(float(p.grad.abs().max()) > 0 for n, p in card.model.named_parameters()
                   if n.startswith(prefix)), prefix


def test_run_training_on_card_matches_cpu(dev, tmp_path):
    """`run_training` of the `tiny` model at the KITTI image size on a small
    KITTI tree (`_torch_kitti_tree.py`): 2 steps and the val set's one batch
    on the card (every training kernel) against the same run on the CPU (the
    plain versions), from the same host-seeded weights and draws: each
    step's loss and the val metrics rtol 1e-3, those from RaySOM's EM
    (loss_som_kl, min_som_vars, total_loss through the KL) by the rest of
    the val loss: a ray whose best prototype is a rounding tie takes another
    Gaussian on the card than on the CPU (kernel S's tests allow 0.1% of
    rays), and moved the val loss_som_kl 1.25e-3 (measured). At lr 0: AdamW's
    first step moves a weight by about +-lr whatever its gradient's size, so
    a gradient whose sign differs between the two (they agree to 1e-2
    relative L2 a leaf, test_tiny_train_step_on_card_matches_cpu) moves the
    weights 2 lr apart, and at lr 1e-5 the second step's loss 2.3e-3 apart
    (measured); the optimizer's update itself is held by the one-step tests."""
    from _torch_kitti_tree import write_kitti_tree
    from scenerf_tpu_torch.cli.train import run_training
    from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch

    tree = write_kitti_tree(str(tmp_path / "kitti"), {"00": 6, "08": 7})
    cfg = C.tiny(img_size=(1220, 370), lr=0.0)
    kw = dict(n_sources=cfg.n_sources, n_rays=cfg.n_gt_depth, seed=42)
    runs, launches = {}, {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        train_ds = KittiDataset("train", tree, str(tmp_path / "pre"), sequences=["00"], **kw)
        val_ds = KittiDataset("val", tree, str(tmp_path / "pre"), **kw)
        build.reset_launch_counts()
        runs[name] = run_training(cfg, train_ds, val_ds, lambda it: to_model_batch(it, cfg),
                                  "exp", str(tmp_path / name), 1, False,
                                  max_steps_per_epoch=2, device=device)
        launches[name] = dict(build.LAUNCHES)
    assert not any(launches["cpu"].values())
    train_kernels = ("gather_levels", "gather_levels_bwd", "sort_composite",
                     "sort_composite_bwd", "ray_som", "bn_stats", "bn_apply", "bn_bwd_reduce",
                     "bn_bwd_apply")
    assert all(launches["card"][k] >= 1 for k in train_kernels), launches["card"]
    assert launches["card"]["ray_som"] == launches["card"]["ray_som_in_sort_composite"]
    cpu, card = runs["cpu"], runs["card"]
    assert len(card["loss"]) == 2
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-3)
    (want,), (got,) = cpu["val_metrics"], card["val_metrics"]
    assert set(got) == set(want)
    som = ("loss_som_kl", "min_som_vars", "total_loss")
    for k in want:
        if k not in som:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["total_loss"] - got["loss_som_kl"],
                               want["total_loss"] - want["loss_som_kl"], rtol=1e-3)


def _bf_tiny_config(**kw):
    """The BundleFusion preset (its loss and sampling fields and sphere
    angles) at the `tiny` widths and 64x48, on an 81x65 sphere (at even
    sizes the preset's symmetric angles put the principal axes on .5 cell
    boundaries, rounding ties between any two implementations)."""
    import dataclasses

    sphere = dataclasses.replace(C.bundlefusion().sphere, width=81, height=65)
    return C.bundlefusion(img_size=(64, 48), sphere=sphere, n_rays=64, n_pts_uni=8,
                          n_gaussians=3, n_pts_per_gaussian=4, d_hidden=32, n_blocks=2,
                          d_latent=0, encoder="tiny", encoder_features=64, n_sources=2,
                          n_gt_depth=32, ray_chunk=32, eval_ray_chunk=64, **kw)


def test_bf_run_training_on_card_matches_cpu(dev, tmp_path):
    """`run_training` of the BundleFusion preset at the tiny widths on a
    fake 64x48 BundleFusion tree (scripts/make_fake_bf.py, all 8 scenes):
    2 steps on apt0 and a val batch on the card against the CPU from the
    same host-seeded weights and draws, at lr 0 (see
    test_run_training_on_card_matches_cpu): each step's loss and the val
    metrics rtol 1e-3, RaySOM's by the rest of the val loss."""
    from scenerf_tpu_torch.cli.train import run_training
    from scenerf_tpu_torch.data.bundlefusion import SPLITS, BundlefusionDataset, to_model_batch
    from scripts.make_fake_bf import write_fake_bf

    root = str(tmp_path / "bf")
    write_fake_bf(root, frames=10, size=(64, 48), scenes=tuple(SPLITS["all"]))
    cfg = _bf_tiny_config(lr=0.0)
    kw = dict(n_sources=cfg.n_sources, frame_interval=1, n_frames=4, seed=42)
    runs, launches = {}, {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        train_ds = BundlefusionDataset("train", root, sequences=["apt0"], **kw)
        val_ds = BundlefusionDataset("val", root, **kw)
        build.reset_launch_counts()
        runs[name] = run_training(cfg, train_ds, val_ds, lambda it: to_model_batch(it, cfg),
                                  "exp", str(tmp_path / name), 1, False,
                                  limit_train_fraction=1.0, max_steps_per_epoch=2,
                                  device=device)
        launches[name] = dict(build.LAUNCHES)
    assert not any(launches["cpu"].values())
    train_kernels = ("gather_levels", "gather_levels_bwd", "sort_composite",
                     "sort_composite_bwd", "ray_som", "bn_stats", "bn_apply", "bn_bwd_reduce",
                     "bn_bwd_apply")
    assert all(launches["card"][k] >= 1 for k in train_kernels), launches["card"]
    cpu, card = runs["cpu"], runs["card"]
    assert len(card["loss"]) == 2
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-3)
    (want,), (got,) = cpu["val_metrics"], card["val_metrics"]
    assert set(got) == set(want)
    som = ("loss_som_kl", "min_som_vars", "total_loss")
    for k in want:
        if k not in som:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["total_loss"] - got["loss_som_kl"],
                               want["total_loss"] - want["loss_som_kl"], rtol=1e-3)


# ---------------------------------------------------------------- kernel T

TSDF_MIN_EQUAL = 0.9999


def _tsdf_check(dev, shape, depths, colors, intrs, w2cs, origin, voxel, trunc, mode,
                init=None):
    """Kernel T and its plain version from the same volume (fresh unless
    `init`): every voxel bit-equal but those at a pixel-rounding tie, and
    these at most 1 - TSDF_MIN_EQUAL of the grid. Returns the kernel's."""
    if init is None:
        init = [torch.full(shape, 255.0, device=dev), torch.zeros(shape, device=dev),
                torch.zeros(shape, device=dev)]
    got = [v.clone() for v in init]
    want = [v.clone() for v in init]
    args = (depths, colors, intrs, w2cs, origin, voxel, trunc, 1.0)
    build.reset_launch_counts()
    integrate(*got, *args, mode=mode)
    integrate_plain(*want, *args, mode=mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES["tsdf_integrate"] == 1
    differs = torch.zeros(shape, dtype=torch.bool, device=dev)
    for a, b in zip(got, want):
        differs |= a != b
    ties = pixel_ties(shape, origin, voxel, intrs, w2cs)
    assert not bool((differs & ~ties).any()), int((differs & ~ties).sum())
    assert float(differs.float().mean()) <= 1 - TSDF_MIN_EQUAL
    return got


def _look_at_grid(dev, F, rng_seed=0):
    """F cameras 1-3 m in front of (and some inside) a 30x24x20 grid of
    0.25 m voxels, looking down +z with small yaws; random depths with a
    zero-depth band, and packed colors."""
    g = torch.Generator(device=dev).manual_seed(rng_seed)
    H, W = 40, 56
    K = torch.tensor([[45.0, 0, 27.7], [0, 45.0, 19.3], [0, 0, 1]], device=dev)
    w2cs = []
    for f in range(F):
        a = 0.1 * f - 0.2
        c2w = torch.eye(4, dtype=torch.float64)
        c2w[0, 0], c2w[0, 2], c2w[2, 0], c2w[2, 2] = math.cos(a), math.sin(a), -math.sin(a), math.cos(a)
        c2w[:3, 3] = torch.tensor([3.5 + 0.3 * f, 3.0, -1.5 + 1.2 * f], dtype=torch.float64)
        w2cs.append(torch.linalg.inv(c2w).float())
    depths = torch.rand(F, H, W, generator=g, device=dev) * 7 + 0.3
    depths[:, 5:8] = 0.0
    rgb = torch.floor(torch.rand(F, H, W, 3, generator=g, device=dev) * 256)
    colors = rgb[..., 2] * 65536.0 + rgb[..., 1] * 256.0 + rgb[..., 0]
    return (30, 24, 20), depths, colors, K.expand(F, 3, 3).contiguous(), torch.stack(w2cs).to(dev)


@pytest.mark.parametrize("mode", ["closest", "average"])
@pytest.mark.parametrize("n_frames", [1, 5])
def test_tsdf_kernel_matches_plain(dev, mode, n_frames):
    """One frame and a 5-frame sweep; cameras inside the grid put voxels
    behind them (c_z < 0), and "average" also runs from a filled volume."""
    shape, depths, colors, K, w2cs = _look_at_grid(dev, n_frames)
    got = _tsdf_check(dev, shape, depths, colors, K, w2cs, (0.0, 0.0, 0.0), 0.25, 0.8, mode)
    assert bool((got[1] > 0).any()) and bool((got[1] == 0).any())
    if mode == "average":
        _tsdf_check(dev, shape, depths, colors, K, w2cs, (0.0, 0.0, 0.0), 0.25, 0.8, mode,
                    init=got)


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_tsdf_kernel_ties_border_and_z_plane(dev, mode):
    """A grid-aligned wall seen by a camera on the grid: projections land
    exactly on .5 boundaries (both round half to even) and on the first and
    last pixel columns and rows; the camera's z = 0 plane runs through a
    voxel layer (z == 0: out of view). The frame is given twice with another
    color: with `>=`, "closest" takes the second frame's color."""
    H, W = 48, 64
    K = torch.tensor([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1]], device=dev)
    depth = torch.full((H, W), 2.0, device=dev)
    colors = torch.stack([torch.full((H, W), 200.0, device=dev),
                          torch.full((H, W), 7.0 * 65536 + 3.0, device=dev)])
    w2c = torch.eye(4, device=dev).expand(2, 4, 4).contiguous()
    shape = (31, 25, 40)
    origin = (-1.875, -1.5, -1.25)  # exact in binary: voxel layer 10 is at z = 0
    got = _tsdf_check(dev, shape, depth.expand(2, H, W).contiguous(), colors,
                      K.expand(2, 3, 3).contiguous(), w2c, origin, 0.125, 10.0, mode)
    assert not bool((got[1][:, :, :11] > 0).any())  # z <= 0: never observed
    if mode == "closest":
        taken = got[0] != 255
        assert bool(taken.any()) and bool((got[2][taken] == 7.0 * 65536 + 3.0).all())


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_tsdf_kernel_kitti_grid_63_frames(dev, mode):
    """The reconstruction chain's shapes: 63 frames of 1220x370 (the CLI's
    default sweep, KITTI calibration) into the 256x256x32 grid."""
    from scenerf_tpu_torch.data.synthetic import kitti_calibration
    from scenerf_tpu_torch.reconstruction import KITTI_VOX_ORIGIN, kitti_volume

    K, T_velo_2_cam = kitti_calibration()
    rel = geo.rel_pose_stack(geo.sample_rel_poses(0.5, 10.0, 10.1))
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(np.linalg.inv(T_velo_2_cam) @ p)
                                      for p in rel]).astype(np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(63)
    depths = torch.rand(63, 370, 1220, generator=g, device=dev) * 40 + 1.0
    colors = torch.floor(torch.rand(63, 370, 1220, generator=g, device=dev) * 2**24)
    shape = kitti_volume("cpu").shape
    got = _tsdf_check(dev, shape, depths, colors,
                      torch.from_numpy(np.tile(K[None], (63, 1, 1))).to(dev), w2cs,
                      KITTI_VOX_ORIGIN, 0.2, 10.0, mode)
    assert float(got[1].max()) <= 63 and bool((got[1] > 0).any())


def _kitti_sweep_cams(dev, n_frames):
    from scenerf_tpu_torch.data.synthetic import kitti_calibration

    K, T_velo_2_cam = kitti_calibration()
    rel = geo.rel_pose_stack(geo.sample_rel_poses(0.5, 10.0, 10.1))[:n_frames]
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(np.linalg.inv(T_velo_2_cam) @ p)
                                      for p in rel]).astype(np.float32)).to(dev)
    return torch.from_numpy(np.tile(K[None], (len(rel), 1, 1))).to(dev), w2cs


@pytest.mark.parametrize("mode", ["closest", "average"])
@pytest.mark.parametrize("n_frames", [1, 63])
def test_tsdf_kernel_ragged_tiles_kitti_poses(dev, mode, n_frames):
    """A 37x53x11 grid (no axis a multiple of the kernel's 32 x 8 x 4 tile,
    lanes along j) of KITTI's voxel size beside and above the camera, where
    the frustum's edges cut it, under the first frame or all 63 of KITTI's
    sweep; the kernel culls some of its tiles (ops.tsdf.tiles_unseen)."""
    from scenerf_tpu_torch.ops.tsdf import lane_axis, tiles_unseen

    K, w2cs = _kitti_sweep_cams(dev, n_frames)
    g = torch.Generator(device=dev).manual_seed(37)
    depths = torch.rand(n_frames, 370, 1220, generator=g, device=dev) * 40 + 1.0
    colors = torch.floor(torch.rand(n_frames, 370, 1220, generator=g, device=dev) * 2**24)
    shape, origin = (37, 53, 11), (2.0, -5.2, -2.0)
    got = _tsdf_check(dev, shape, depths, colors, K, w2cs, origin, 0.2, 10.0, mode)
    assert bool((got[1] > 0).any())
    assert lane_axis(w2cs.cpu()) == 1
    assert bool(tiles_unseen(shape, origin, 0.2, K.cpu(), w2cs.cpu(), 370, 1220).any())


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_tsdf_kernel_culled_frames(dev, mode):
    """Between two frames in view, one whose camera stands 1 km to the side
    (every tile past the image's right edge) and one turned round (every
    voxel behind it): the kernel culls those frames for every tile, and the
    volumes equal the plain version's."""
    from scenerf_tpu_torch.ops.tsdf import tiles_unseen

    shape, depths, colors, K, w2cs = _look_at_grid(dev, 2, rng_seed=5)
    far = torch.eye(4, device=dev)
    far[0, 3], far[2, 3] = 1000.0, 1.0
    back = torch.diag(torch.tensor([-1.0, 1.0, -1.0, 1.0], device=dev))
    back[2, 3] = -1.0
    M = torch.stack([w2cs[0], far, back, w2cs[1]])
    K4 = K[:1].expand(4, 3, 3).contiguous()
    got = _tsdf_check(dev, shape, torch.cat([depths, depths]), torch.cat([colors, colors]), K4,
                      M, (0.0, 0.0, 0.0), 0.25, 0.8, mode)
    assert bool((got[1] > 0).any())
    unseen = tiles_unseen(shape, (0.0, 0.0, 0.0), 0.25, K4.cpu(), M.cpu(), *depths.shape[1:])
    assert bool(unseen[:, 1].all() and unseen[:, 2].all())


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_tsdf_kernel_projections_an_ulp_from_half(dev, mode):
    """A voxel layer at depth 1 under fx = fy = 8 at 0.125 m voxels: every
    projection is an integer plus a principal point an ulp above .5 (one
    frame) or below it (the next), so each rounds the other way, and the
    image's last column and row take a voxel in one frame only:
    bit-equal to the plain version, no voxel excepted."""
    H, W = 10, 12
    w2c = torch.eye(4, device=dev)
    w2c[2, 3] = 1.0  # the grid's first z layer at camera depth 1
    Ks = []
    for delta in (2.0**-20, -(2.0**-20)):
        Ks.append(torch.tensor([[8.0, 0, 0.5 + delta], [0, 8.0, 0.5 + delta], [0, 0, 1]],
                               device=dev))
    K = torch.stack(Ks)
    depths = torch.full((2, H, W), 1.5, device=dev)
    colors = torch.stack([torch.full((H, W), 11.0, device=dev),
                          torch.full((H, W), 5.0 * 65536, device=dev)])
    shape = (W + 3, H + 3, 5)
    vols = [[torch.full(shape, 255.0, device=dev), torch.zeros(shape, device=dev),
             torch.zeros(shape, device=dev)] for _ in range(2)]
    args = (depths, colors, K, w2c.expand(2, 4, 4).contiguous(), (0.0, 0.0, 0.0), 0.125, 10.0,
            1.0)
    build.reset_launch_counts()
    integrate(*vols[0], *args, mode=mode)
    integrate_plain(*vols[1], *args, mode=mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES["tsdf_integrate"] == 1
    for a, b in zip(*vols):
        assert torch.equal(a, b)
    assert bool((vols[0][1] == 2).any()) and bool((vols[0][1] == 1).any())


@pytest.mark.parametrize("mode", ["closest", "average"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_tsdf_kernel_volume_at_unaligned_offset(dev, mode, offset):
    """Volumes that are contiguous views starting `offset` floats into their
    buffers (4-B aligned, not 16-B): the kernel reads and writes them with
    scalar loads, and equals the plain version."""
    shape, depths, colors, K, w2cs = _look_at_grid(dev, 3, rng_seed=offset)
    n = math.prod(shape)
    got = [torch.empty(n + offset, device=dev)[offset:].view(shape) for _ in range(3)]
    assert all(v.is_contiguous() and v.data_ptr() % 16 == 4 * offset for v in got)
    got[0].fill_(255.0)
    got[1].zero_()
    got[2].zero_()
    want = [torch.full(shape, 255.0, device=dev), torch.zeros(shape, device=dev),
            torch.zeros(shape, device=dev)]
    args = (depths, colors, K, w2cs, (0.0, 0.0, 0.0), 0.25, 0.8, 1.0)
    integrate(*got, *args, mode=mode)
    integrate_plain(*want, *args, mode=mode)
    torch.cuda.synchronize()
    differs = torch.zeros(shape, dtype=torch.bool, device=dev)
    for a, b in zip(got, want):
        differs |= a != b
    ties = pixel_ties(shape, (0.0, 0.0, 0.0), 0.25, K, w2cs)
    assert not bool((differs & ~ties).any()) and bool((got[1] > 0).any())


def test_tsdf_plan_constants_match_the_kernel(dev):
    """The plain twin of kernel T's plan (ops.tsdf: tiles and cull) uses the
    tile extents and cull constants the built kernel has."""
    from scenerf_tpu_torch.ops import tsdf as T

    assert T.kernel_plan_constants() == (T.TILE_LANES, T.TILE_WARPS, T.TILE_RUN,
                                         T.CULL_MARGIN, T.CULL_MAX_PIXEL)


@pytest.mark.parametrize("mode", ["closest", "average"])
def test_tsdf_kernel_bf_grid_sweep(dev, mode):
    """BundleFusion's 120x120x96 grid at 0.04 m under its 33-pose sweep
    (lanes along x) of a 640x480 room 1-4 m deep."""
    from scenerf_tpu_torch.cli.reconstruction import bf_rel_poses
    from scenerf_tpu_torch.ops.tsdf import lane_axis
    from scenerf_tpu_torch.reconstruction import BF_VOX_ORIGIN

    poses = list(bf_rel_poses(30.0, 0.2, 2.1).values())
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(np.asarray(p)) for p in poses])
                            .astype(np.float32)).to(dev)
    F_, H, W = len(poses), 480, 640
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    room = 2.5 + 1.5 * torch.sin(xx / 160.0) * torch.sin(yy / 120.0)
    g = torch.Generator(device=dev).manual_seed(33)
    depths = (room + 0.05 * torch.rand(F_, H, W, generator=g, device=dev)).contiguous()
    colors = torch.floor(torch.rand(F_, H, W, generator=g, device=dev) * 2**24)
    K = torch.tensor([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], device=dev)
    got = _tsdf_check(dev, (120, 120, 96), depths, colors, K.expand(F_, 3, 3).contiguous(),
                      w2cs, tuple(float(o) for o in BF_VOX_ORIGIN), 0.04, 10.0, mode)
    assert lane_axis(w2cs.cpu()) == 0 and bool((got[1] > 0).any())


def test_marching_cubes_on_card_fused_volume(dev):
    """BundleFusion's grid (120x120x96 at 0.04 m) fused on the card by
    kernel T from 16 frames of a room seen from yawed cameras, and on the
    CPU by the plain version: the volumes bit-equal but at pixel-rounding
    ties; the mesh of the card's volume (`get_mesh` reads it back) equals
    marching cubes of its host copy, and matches the CPU volume's mesh where
    the volumes are equal (the vertex counts within 0.1%)."""
    from scenerf_tpu_torch.reconstruction import BF_VOX_ORIGIN, bf_volume
    from scenerf_tpu_torch.fusion.meshing import marching_cubes

    g = torch.Generator().manual_seed(16)
    H, W, F_ = 96, 128, 16
    K = torch.tensor([[105.0, 0, 63.7], [0, 105.0, 47.3], [0, 0, 1]])
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    c2ws = []
    for f in range(F_):
        a = 0.04 * f - 0.3
        c2w = torch.eye(4, dtype=torch.float64)
        c2w[0, 0], c2w[0, 2], c2w[2, 0], c2w[2, 2] = math.cos(a), math.sin(a), -math.sin(a), math.cos(a)
        c2w[:3, 3] = torch.tensor([0.05 * f - 0.4, 0.02 * f, 0.1], dtype=torch.float64)
        c2ws.append(c2w.numpy())
    depths = (2.0 + 0.8 * torch.sin(xx / 17.0) * torch.cos(yy / 13.0)
              + 0.01 * torch.rand(F_, H, W, generator=g)).float()
    colors = torch.floor(torch.rand(F_, H, W, 3, generator=g) * 256)
    vols = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        vol = bf_volume(device)
        build.reset_launch_counts()
        vol.integrate_frames(colors.to(device), depths.to(device), K.expand(F_, 3, 3).numpy(),
                             np.stack(c2ws))
        assert build.LAUNCHES["tsdf_integrate"] == (name == "card")
        vols[name] = vol
    assert vols["card"].shape == (120, 120, 96)
    got, want = vols["card"].get_volume(), vols["cpu"].get_volume()
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(c) for c in c2ws]).astype(np.float32))
    ties = pixel_ties((120, 120, 96), BF_VOX_ORIGIN.astype(np.float32), 0.04,
                      K.expand(F_, 3, 3), w2cs).numpy()
    differs = (got[0] != want[0]) | (got[1] != want[1])
    assert not (differs & ~ties).any() and differs.mean() <= 1 - TSDF_MIN_EQUAL
    verts, faces, norms, vcolors = vols["card"].get_mesh()
    v0, f0, n0 = marching_cubes(got[0])
    np.testing.assert_array_equal(faces, f0)
    np.testing.assert_array_equal(norms, n0)
    np.testing.assert_array_equal(verts, v0 * np.float32(0.04) + BF_VOX_ORIGIN.astype(np.float32))
    assert len(faces) > 1000 and vcolors.shape == verts.shape
    cpu_mesh = vols["cpu"].get_mesh()
    if not differs.any():
        for a, b in zip((verts, faces, norms, vcolors), cpu_mesh):
            np.testing.assert_array_equal(a, b)
    assert abs(len(verts) - len(cpu_mesh[0])) <= 1e-3 * len(cpu_mesh[0])


# ---------------------------------------------------------------- kernel K5

BN_SHAPES = [(1, 80), (7, 3), (1000, 2), (468, 3840), (2501, 80), (678000, 80)]
BN_REL_L2 = 1e-4  # dx, dweight, dbias, d_residual: sums in another order, terms that cancel


def _bn_inputs(dev, M, C, res, seed=0):
    """x [M, C] with channel 0 constant (the variance tie), the per-channel
    vectors, a residual (or None) and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed + M + C)
    x = torch.randn(M, C, generator=g, device=dev) * 2 + 0.5
    x[:, 0] = 0.5
    vec = lambda lo, span: torch.rand(C, generator=g, device=dev) * span + lo  # noqa: E731
    r = torch.randn(M, C, generator=g, device=dev) if res else None
    dy = torch.randn(M, C, generator=g, device=dev)
    return x, vec(0.5, 1.0), vec(-0.5, 1.0), vec(-0.2, 0.4), vec(0.5, 1.0), r, dy


def _bn_both(x, w, b, rm, rv, r, dy, training, act, mom=0.9, eps=1e-5):
    """The fused op through the kernels and through the plain version (its
    autograd) on copies of the same inputs: per side (y, running mean,
    running var, dx, dweight, dbias, d_residual), and the kernel side's
    launch counts. The cotangent is zeroed at the leaky-ReLU's kink ties
    (`N.kink_ties`: z within rounding of 0, where the two sides' statistics
    may pick different slopes)."""
    if training:
        stats = N.stats_plain(x, w, b, rm.clone(), rv.clone(), mom, eps)
    else:
        stats = N.fold_plain(w, b, rm, rv, eps)
    dy = torch.where(N.kink_ties(x, stats, act, r), torch.zeros_like(dy), dy)
    out = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        rr = None if r is None else r.clone().requires_grad_(True)
        stats = [rm.clone(), rv.clone()]
        build.reset_launch_counts()
        if plain:
            with build.plain_versions():
                y = N.batch_norm_act(*leaves, *stats, training, mom, eps, act, rr)
        else:
            y = N.batch_norm_act(*leaves, *stats, training, mom, eps, act, rr)
        y.backward(dy)
        if not plain:
            launches = dict(build.LAUNCHES)
        out.append([y.detach(), *stats, *(t.grad for t in leaves),
                    None if rr is None else rr.grad])
    torch.cuda.synchronize()
    return out[0], out[1], launches


def _rel_l2(a, b, floor):
    return float((a - b).norm()) / max(float(b.norm()), floor)


def _bn_check(got, want, x, dy, w, var, eps, what):
    """y and the running statistics at rtol 1e-5 (atol 1e-6 of the largest
    summand x mul of z); dx, dweight, dbias and d_residual by relative L2 <=
    BN_REL_L2. With one row (M = 1) dx and dweight are 0 up to rounding (x is
    its own mean): there they are held against the scale of their terms."""
    y, rm, rv_, dx, dw, db, dr = got
    y0, rm0, rv0, dx0, dw0, db0, dr0 = want
    inv = torch.rsqrt(var + eps)
    mul = (w * inv).abs().max()
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-6 * float((x.abs().max() * mul)),
                               msg=f"{what} y")
    for a, b, n in ((rm, rm0, "running_mean"), (rv_, rv0, "running_var")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()),
                                   msg=f"{what} {n}")
    one_row = x[..., 0].numel() == 1
    floors = {"dx": float(dy.norm()) * float(mul) if one_row else 0.0,
              "dweight": float((dy * x).norm() * inv.max()) if one_row else 0.0,
              "dbias": 0.0, "d_residual": 0.0}
    for a, b, n in ((dx, dx0, "dx"), (dw, dw0, "dweight"), (db, db0, "dbias"),
                    (dr, dr0, "d_residual")):
        if b is None:
            assert a is None, (what, n)
            continue
        assert bool(torch.isfinite(a).all()), (what, n)
        err = _rel_l2(a, b, floors[n])
        assert err <= BN_REL_L2, (what, n, err)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("M,C", BN_SHAPES)
def test_bn_kernels_train_match_plain(dev, M, C, act, res):
    """N1-N4 in train mode against the plain version and its autograd: C in
    {2, 3, 80, 3840} (scalar and vector paths), M from 1 to 678,000 (the
    decoder's 452x1500 level), a constant channel."""
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, res)
    got, want, launches = _bn_both(x, w, b, rm, rv, r, dy, True, act)
    assert (launches["bn_stats"], launches["bn_apply"], launches["bn_bwd_reduce"],
            launches["bn_bwd_apply"]) == (1, 1, 1, 1), launches
    _bn_check(got, want, x, dy, w, x.var(0, unbiased=False), 1e-5,
              f"train M={M} C={C} {act} res={res}")


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("M,C", [(7, 3), (468, 3840), (2501, 80)])
def test_bn_kernels_eval_match_plain(dev, M, C, act, res):
    """Eval mode: one N2 launch folding the running statistics (no N1), y
    bit-equal to the plain version but for the fold's rounding; the backward
    (N3, N4) with the statistics held constant."""
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, res, seed=1)
    got, want, launches = _bn_both(x, w, b, rm, rv, r, dy, False, act)
    assert (launches["bn_stats"], launches["bn_apply"], launches["bn_bwd_reduce"],
            launches["bn_bwd_apply"]) == (0, 1, 1, 1), launches
    assert torch.equal(got[1], rm) and torch.equal(got[2], rv)
    _bn_check(got, want, x, dy, w, rv, 1e-5, f"eval M={M} C={C} {act} res={res}")
    # without autograd: one launch, nothing saved
    build.reset_launch_counts()
    with torch.no_grad():
        y = N.batch_norm_act(x, w, b, rm, rv, False, 0.9, 1e-5, act, r)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bn_apply"] == 1 and sum(build.LAUNCHES.values()) == 1
    torch.testing.assert_close(y, got[0], rtol=0, atol=0)


@pytest.mark.parametrize("offset", [0, 1])
def test_bn_kernels_vector_and_scalar_paths(dev, offset):
    """C = 80 at a 16-byte aligned base (float4 path) and 4 bytes off it
    (scalar path): the same results as the plain version."""
    M, C = 3000, 80
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=2)
    bufs = [torch.empty(M * C + offset, device=dev) for _ in range(3)]
    views = []
    for buf, t in zip(bufs, (x, r, dy)):
        v = buf[offset:].view(M, C)
        v.copy_(t)
        views.append(v)
    got, want, _ = _bn_both(views[0], w, b, rm, rv, views[1], views[2], True, "silu")
    _bn_check(got, want, x, dy, w, x.var(0, unbiased=False), 1e-5, f"offset {offset}")


def test_bn_function_directional_derivative(dev):
    """Gradcheck in f32: the autograd.Function's gradient along a random
    direction against the central difference of its forward (train mode,
    SiLU with the residual: smooth, so the difference has no kink to cross),
    within 1%."""
    M, C = 4000, 12
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=3)
    g = torch.Generator(device=dev).manual_seed(5)
    # no constant channel here: at var = 0 a step of h moves var by h^2,
    # against eps 1e-5, and the difference quotient leaves its linear range
    x = torch.randn(M, C, generator=g, device=dev) * 2 + 0.5
    dirs = [torch.randn(t.shape, generator=g, device=dev) for t in (x, w, b, r)]

    def loss(xx, ww, bb, rr):
        y = N.batch_norm_act(xx, ww, bb, rm.clone(), rv.clone(), True, 0.9, 1e-5, "silu", rr)
        return (y * dy).sum(dtype=torch.float64)

    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, r)]
    loss(*leaves).backward()
    along = sum(float((l.grad * d).sum(dtype=torch.float64)) for l, d in zip(leaves, dirs))
    h = 1e-3
    with torch.no_grad():
        plus = loss(*(t + h * d for t, d in zip((x, w, b, r), dirs)))
        minus = loss(*(t - h * d for t, d in zip((x, w, b, r), dirs)))
    fd = float(plus - minus) / (2 * h)
    assert abs(fd - along) <= 1e-2 * abs(along), (fd, along)


def test_plain_versions_keep_k5(dev):
    """`plain_versions(keep=("bn",))`: every kernel but K5 runs its plain
    version (the training-step comparison of chip_smoke.py runs so)."""
    lv = torch.randn(4, 5, 8, device=dev)
    xy = torch.zeros(1, 10, device=dev)
    x = torch.randn(2, 3, 4, 8, device=dev)
    v = torch.ones(8, device=dev)
    build.reset_launch_counts()
    with build.plain_versions(keep=("bn",)):
        gather_levels([lv], xy, xy)
        N.batch_norm_act(x, v, v, v.clone(), v.clone(), True, 0.9, 1e-5, "leaky")
    assert build.LAUNCHES["gather_levels"] == 0
    assert (build.LAUNCHES["bn_stats"], build.LAUNCHES["bn_apply"]) == (1, 1)


def test_bn_kernel_raises_on_layout(dev):
    """An input neither contiguous channel-last nor channel-first (a strided
    slice) raises; no copy. A residual of another layout raises too."""
    x = torch.randn(2, 5, 12, 8, device=dev)[:, :, ::2]
    v = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        N.batch_norm_act(x, v, v, v.clone(), v.clone(), True, 0.9, 1e-5, "silu")
    x = x.contiguous()
    r = torch.randn(2, 8, 5, 6, device=dev).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="layout"):
        N.batch_norm_act(x, v, v, v.clone(), v.clone(), True, 0.9, 1e-5, "silu", r)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("shape", [(2, 37, 61, 24), (1, 185, 610, 64), (1, 3, 5, 3840)])
def test_bn_kernels_channel_first_match_plain(dev, shape, act, training):
    """Channel-first inputs ([B, H, W, C] views of NCHW-contiguous tensors, as
    the eval encoder's stem convolution gives): N1-N4 against the plain
    version, with the residual; the outputs keep the layout."""
    B, H, W, C = shape
    g = torch.Generator(device=dev).manual_seed(C)
    cf = lambda: torch.randn(B, C, H, W, generator=g, device=dev).permute(0, 2, 3, 1)  # noqa: E731
    x, r, dy = cf() * 2 + 0.5, cf(), cf()
    assert N.plane(x) == H * W and not x.is_contiguous()
    w = torch.rand(C, generator=g, device=dev) + 0.5
    b = torch.rand(C, generator=g, device=dev) - 0.5
    rm = torch.rand(C, generator=g, device=dev) * 0.4 - 0.2
    rv = torch.rand(C, generator=g, device=dev) + 0.5
    got, want, launches = _bn_both(x, w, b, rm, rv, r, dy, training, act)
    assert (launches["bn_stats"], launches["bn_bwd_apply"]) == (int(training), 1), launches
    assert got[0].stride() == x.stride() and got[3].stride() == x.stride()
    var = x.reshape(-1, C).var(0, unbiased=False) if training else rv
    _bn_check(got, want, x, dy, w, var, 1e-5, f"channel-first {shape} {act}")


# ---------------------------------------------------------------- K5's two paths

# the streaming reductions' tickets at the head of their workspace: one for
# each 32-channel column of the widest C (65535), rounded up to 64
WORK_TICKETS = 2048


def _boundary_m(C, itemsize, direction, act, res):
    """The largest M whose launch `N.plan` puts on the cluster path (the next
    M takes the streaming path)."""
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        vector = C % (16 // itemsize) == 0
        if N.plan(mid, C, itemsize, vector, direction, act, res).path == "cluster":
            lo = mid
        else:
            hi = mid
    return lo


def _both_paths(x, w, b, rm, rv, r, dy, act, split=False):
    """The forward and the backward (on the plain statistics) through the
    wrappers, as one launch of stages 3 each (the path `N.plan` picks) or,
    with `split`, as stage 1 then stage 2 (the streaming kernels), against
    the plain stages: the statistics and running statistics at rtol 1e-5;
    y against the plain apply on the launch's own statistics (f32 rtol 1e-5,
    bf16 within one bf16 spacing); the gradients at relative L2 <= 1e-4 and
    dx, d_residual (against the plain apply on the launch's own gradients)
    at 1e-4 in f32, BF16_DX_REL_L2 in bf16. Returns the launch counts and
    the outputs."""
    mom, eps = 0.9, 1e-5
    build.reset_launch_counts()
    run = [rm.clone(), rv.clone()]
    y, st = N.launch_forward(x, w, b, *run, True, mom, eps, act, r, stages=1 if split else 3)
    if split:
        N.launch_forward(x, w, b, *run, True, mom, eps, act, r, stages=2, y=y, stats=st)
    rp = [rm.clone(), rv.clone()]
    st_p = N.stats_plain(x, w, b, *rp, mom, eps)
    dx, gr, d_r = N.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                    residual_grad=r is not None, stages=1 if split else 3)
    if split:
        N.launch_backward(x, dy, w, st_p, True, eps, act, r, residual_grad=r is not None,
                          stages=2, grads=gr, dx=dx, d_res=d_r)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # channel 0 is constant: the kernels' mean is exact (s / M in f64), so
    # mean2 - mean^2 ties at 0 exactly; torch's CUDA mean multiplies by a
    # rounded 1 / M and may miss 0.5 by a spacing, which moves rsqrt(var + eps)
    # by 1e-3 relative there: channel 0 is held to the exact tie instead
    assert float(st[N.VAR_RAW, 0]) == 0.0 and float(st[N.MEAN, 0]) == 0.5
    torch.testing.assert_close(st[N.INV, 0], torch.tensor(eps, device=x.device) ** -0.5,
                               rtol=2.5e-7, atol=0)
    assert torch.equal(st[N.MUL, 0], w[0] * st[N.INV, 0])
    assert torch.equal(st[N.ADD, 0], b[0] - st[N.MEAN, 0] * st[N.MUL, 0])
    for a, b_ in [(st[i, 1:], st_p[i, 1:]) for i in range(5)] + [(st[N.MEAN], st_p[N.MEAN]),
                                                                 (run[0], rp[0]),
                                                                 (run[1], rp[1])]:
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6 * float(b_.abs().max()))
    y_p = N.apply_plain(x, st, act, r)
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-6 * float(y_p.abs().max()))
    else:
        torch.testing.assert_close(y.float(), y_p.float(), rtol=2.0 ** -7,
                                   atol=1e-6 * float(y_p.float().abs().max()))
    gr_p = N.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)
    # with one row x is its own mean: dweight and dx are 0 up to rounding,
    # held (as _bn_check holds them) against the scale of their terms; alpha
    # and beta carry that rounding residue of sum g x - mean sum g times
    # rsqrt(var + eps) / (var + eps) at var = 0 (3e7 at eps 1e-5): there
    # they are held through dx, which the plain apply takes from them
    one_row = x.numel() == x.shape[-1]
    scale = float(dy.float().norm()) * float(st_p[N.INV].max()) * float(w.abs().max())
    rows = (N.DWEIGHT, N.DBIAS) if one_row else range(4)
    for i in rows:
        floor = scale * (float(x.float().norm()) + 1.0) if one_row and i == N.DWEIGHT else \
            1e-6 * float(gr_p.abs().max())
        err = _rel_l2(gr[i], gr_p[i], floor)
        assert err <= BN_REL_L2, (i, err)
    assert bool(torch.isfinite(gr).all())
    dx_p, dr_p = N.bwd_apply_plain(x, dy, st_p, gr, act, r)
    lim = BN_REL_L2 if x.dtype == torch.float32 else BF16_DX_REL_L2
    for a, b_, floor in ((dx, dx_p, scale if one_row else 1e-30),
                         (d_r, dr_p if r is not None else None, 1e-30)):
        if b_ is not None:
            assert _rel_l2(a.float(), b_.float(), floor) <= lim
    return launches, (y, st, gr, dx, d_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction,act,res", [("forward", "silu", False),
                                               ("forward", "leaky", True),
                                               ("backward", "silu", False),
                                               ("backward", "leaky", True)])
def test_bn_paths_at_their_boundary(dev, dtype, direction, act, res):
    """The largest M of a 288-channel site on the cluster path (one launch a
    direction: `bn_*_fused` counted) and the next M, which takes the
    streaming path (a reduction finalizing in its last block, then the
    apply), both against the plain versions."""
    C = 288
    itemsize = torch.empty(0, dtype=dtype).element_size()
    m = _boundary_m(C, itemsize, direction, act, res)
    fused = "bn_forward_fused" if direction == "forward" else "bn_backward_fused"
    for M, want in ((m, 1), (m + 1, 0)):
        x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, res)
        x, r, dy = (None if t is None else t.to(dtype) for t in (x, r, dy))
        launches, _ = _both_paths(x, w, b, rm, rv, r, dy, act)
        assert launches[fused] == want, (M, launches)
        assert (launches["bn_stats"], launches["bn_apply"], launches["bn_bwd_reduce"],
                launches["bn_bwd_apply"]) == (1, 1, 1, 1), launches


@pytest.mark.parametrize("path", ["plan", "streaming"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("M,C,offset", [(1, 80, 0), (7, 3, 0), (1000, 2, 0), (300, 12, 0),
                                        (2501, 80, 1), (468, 3840, 0), (7191, 480, 0)])
def test_bn_paths_edge_shapes(dev, M, C, offset, act, res, dtype, path):
    """Both paths (the plan's, which is the cluster path at these sizes, and
    the streaming path forced) at the edge shapes: one row, C = 2 and 3 (the
    scalar path), C not a multiple of the vector width in bf16 (12), a base
    one element off 16 bytes (scalar loads), the /32 and /8 sites; channel 0
    constant (the variance tie)."""
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, res, seed=7)
    views = []
    for t in (x, r, dy):
        if t is None:
            views.append(None)
            continue
        buf = torch.empty(M * C + offset, device=dev, dtype=dtype)
        v = buf[offset:].view(M, C)
        v.copy_(t)
        views.append(v)
    x, r, dy = views
    split = path == "streaming"
    launches, _ = _both_paths(x, w, b, rm, rv, r, dy, act, split)
    itemsize = x.element_size()
    vector = C % (16 // itemsize) == 0 and offset == 0
    want = N.plan(M, C, itemsize, vector, "forward", act, res).path == "cluster" and not split
    assert launches["bn_forward_fused"] == int(want), launches


@pytest.mark.parametrize("M,C", [(1848, 1344), (28365, 48), (678000, 80)])
def test_bn_paths_deterministic_and_graph_replay(dev, M, C):
    """The statistics, gradients and outputs bit-equal across two eager runs
    and three replays of one CUDA graph of a forward + backward (bf16,
    leaky + residual); the streaming reductions' tickets back at 0 after
    the replays."""
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=9)
    x, r, dy = (t.to(torch.bfloat16) for t in (x, r, dy))
    st_p = N.stats_plain(x, w, b, rm.clone(), rv.clone(), 0.9, 1e-5)

    def step():
        y, st = N.launch_forward(x, w, b, rm.clone(), rv.clone(), True, 0.9, 1e-5, "leaky", r)
        dx, gr, d_r = N.launch_backward(x, dy, w, st_p, True, 1e-5, "leaky", r,
                                        residual_grad=True)
        return [y, st, dx, gr, d_r]

    first, second = step(), step()
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b_ in zip(outs, first):
            assert torch.equal(a, b_)
    for buf in N._work.values():
        assert int(buf[:WORK_TICKETS].view(torch.int32).count_nonzero()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,act,res", [(169500, 160, "silu", True), (28365, 288, "silu", False),
                                         (10528, 640, "leaky", True)])
def test_bn_synced_split_bit_equal_to_streaming(dev, M, C, act, res, dtype):
    """The synced path (`batch_norm_act_synced`) at a world of one rank (no
    group: the all-reduces are the identity), through its autograd.Function,
    against the streaming kernels launched stage by stage, at three sites of
    the B7 training step (226x750x160 + residual, 93x305x288, 56x188x640 +
    residual): the reductions take the same tiles and hand the same f64 sums
    to the same finalize arithmetic, so y, the running statistics, dx,
    dweight, dbias and d_residual are bit-equal; one launch of each synced
    stage, none of the one-launch path."""
    mom, eps = 0.99, 1e-3
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, res, seed=11)
    x, r, dy = (None if t is None else t.to(dtype) for t in (x, r, dy))
    run_s = [rm.clone(), rv.clone()]
    y_s, st_s = N.launch_forward(x, w, b, *run_s, True, mom, eps, act, r, stages=1)
    N.launch_forward(x, w, b, *run_s, True, mom, eps, act, r, stages=2, y=y_s, stats=st_s)
    dx_s, gr_s, dr_s = N.launch_backward(x, dy, w, st_s, True, eps, act, r, residual_grad=res,
                                         stages=1)
    N.launch_backward(x, dy, w, st_s, True, eps, act, r, residual_grad=res, stages=2,
                      grads=gr_s, dx=dx_s, d_res=dr_s)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    rr = None if r is None else r.clone().requires_grad_(True)
    run = [rm.clone(), rv.clone()]
    build.reset_launch_counts()
    y = N.batch_norm_act_synced(*leaves, *run, mom, eps, act, rr, group=None)
    y.backward(dy)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    assert all(launches[k] == 1 for k in build.BN_SYNC_KERNELS + ("bn_apply", "bn_bwd_apply")), \
        launches
    assert launches["bn_stats"] == launches["bn_bwd_reduce"] == 0, launches
    assert launches["bn_forward_fused"] == launches["bn_backward_fused"] == 0, launches
    for got, want, what in ((y, y_s, "y"), (run[0], run_s[0], "running mean"),
                            (run[1], run_s[1], "running var"), (leaves[0].grad, dx_s, "dx"),
                            (leaves[1].grad, gr_s[N.DWEIGHT], "dweight"),
                            (leaves[2].grad, gr_s[N.DBIAS], "dbias")):
        assert torch.equal(got, want), (what, float((got.float() - want.float()).abs().max()))
    if res:
        assert torch.equal(rr.grad, dr_s if act != "identity" else dy)


@pytest.mark.parametrize("M,C,act", [(169500, 160, "silu"), (10528, 640, "leaky")])
def test_bn_synced_finalizes_local_and_world(dev, M, C, act):
    """The synced finalizes on sums as two ranks hand them over: this rank's
    and the world's (this rank's plus a second rank's, over 2M rows). The
    statistics from the world's sums, the running statistics moved, and the
    gradients (dweight, dbias from the rank's sums; dx's alpha and beta from
    the world's) against their plain versions on the same sums; the local
    and world sums swapped miss the plain gradients a thousandfold beyond
    the bar, so the check tells them apart."""
    mom, eps = 0.99, 1e-3
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=11)
    xo, _, _, _, _, ro, dyo = _bn_inputs(dev, M, C, True, seed=12)
    world = N.sums_plain(x) + N.sums_plain(xo)
    run_k, run_p = [rm.clone(), rv.clone()], [rm.clone(), rv.clone()]
    st_k = N.launch_stats_finalize(world, 2 * M, x, w, b, *run_k, mom, eps)
    st_p = N.stats_finalize_plain(world, 2 * M, w, b, *run_p, mom, eps)
    for got, want in ((st_k, st_p), (run_k[0], run_p[0]), (run_k[1], run_p[1])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    local = N.bwd_sums_plain(x, dy, st_p, act, r)
    g_world = local + N.bwd_sums_plain(xo, dyo, st_p, act, ro)
    got = N.launch_grads_finalize(local, g_world, 2 * M, x, st_p, w, eps)
    want = N.grads_finalize_plain(local, g_world, 2 * M, st_p, w, eps)
    torch.cuda.synchronize()
    rel = lambda a, b_: float((a - b_).norm() / b_.norm())  # noqa: E731
    for row in range(4):
        assert rel(got[row], want[row]) <= 1e-5, (row, rel(got[row], want[row]))
    from_world = N.grads_finalize_plain(g_world, g_world, 2 * M, st_p, w, eps)
    from_local = N.grads_finalize_plain(local, local, 2 * M, st_p, w, eps)
    assert rel(from_world[:2], want[:2]) > 1e-2 and rel(from_local[2:], want[2:]) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_streaming_past_8192_channels(dev, dtype):
    """C = 8224 on the streaming kernels (stage 1, then stage 2): 257 columns
    of 32 channels, each with its ticket in the workspace's head, which holds
    one for every column of the widest C; run after a narrow launch and
    again, so that the partials of one width never land on the tickets of
    another. Against the plain versions."""
    for M, C in ((300, 8224), (4000, 80), (300, 8224)):
        x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=11)
        x, r, dy = (t.to(dtype) for t in (x, r, dy))
        launches, _ = _both_paths(x, w, b, rm, rv, r, dy, "leaky", split=True)
        assert launches["bn_forward_fused"] == launches["bn_backward_fused"] == 0
    for buf in N._work.values():
        assert int(buf[:WORK_TICKETS].view(torch.int32).count_nonzero()) == 0


def test_bn_cluster_plan_refused_raises(dev, monkeypatch):
    """A cluster tiling the kernels or the card refuse raises (nothing falls
    back): more than 16 blocks a cluster, shared memory other than the
    kernel's layout, more shared memory than a block may have, too few rows
    for M, a cluster plan for a stage launched alone."""
    M, C = 1000, 80
    x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, False)
    good = N.plan(M, C, 4, True, "forward", "silu", False)
    assert good.path == "cluster"
    big = x.repeat(200, 1)
    huge = good._replace(cluster=1, rows=big.shape[0],
                         smem=N.cluster_smem(big.shape[0], good.sv, 16, 1, good.sv * 4))
    assert huge.smem > 227 * 1024  # the most shared memory an H100 block may have
    bad = [(x, 3, good._replace(cluster=32, rows=-(-M // 32))),
           (x, 3, good._replace(smem=good.smem + 16)),
           (x, 3, good._replace(rows=good.rows // 2)),
           (x, 1, good),
           (big, 3, huge)]
    for t, stages, p in bad:
        monkeypatch.setattr(N, "launch_path", lambda *args, p=p: p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            N.launch_forward(t, w, b, rm.clone(), rv.clone(), True, 0.9, 1e-5, "silu",
                             stages=stages)


# ---------------------------------------------------------------- bf16 instantiations

BF16 = torch.bfloat16
BF16_DX_REL_L2 = 4e-3  # bf16 dx, d_residual: one rounding each (2^-8), statistics in another order


@pytest.mark.parametrize("n", [40000, 700])
@pytest.mark.parametrize("widths", [(2, 4, 8, 16, 32), (80, 160, 320, 640, 1280), (3,),
                                    (5, 12, 7), (24,), (48, 224)])
def test_gather_kernel_bf16_bit_equal(dev, widths, n):
    """Kernel G's bf16 instantiation (bf16 levels and output, f32 coords and
    weights, each output rounded once) bit-equal to its plain version: the
    8-channel vectors (C a multiple of 8), the scalar loop (C = 2, 3, 5, 7,
    12), the cp.async ring (rows of >= 640 bytes: 320 bf16 channels) at one
    round per warp, and coords off the map; the lane groups sized by 8
    channels a lane."""
    g = torch.Generator(device=dev).manual_seed(len(widths) + n)
    levels = [torch.randn(9 + i, 13 + 2 * i, c, generator=g, device=dev).to(BF16)
              for i, c in enumerate(widths)]
    ix, iy = _coords(g, levels, n, dev)
    build.reset_launch_counts()
    got = gather_levels(levels, ix, iy)
    want = gather_levels_plain(levels, ix, iy)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and build.LAUNCHES["gather_levels_bf16"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if n == 40000:
        assert G.lanes_per_point(widths, n, BF16) == min(
            32, 1 << (-(-max(widths) // 8) - 1).bit_length())


def test_gather_kernel_bf16_misaligned_and_mixed(dev):
    """A bf16 level 2 bytes off 16-byte alignment takes the scalar loop (same
    result as the plain version); an f32 level beside bf16 ones raises, and
    so does an f16 level (no instantiation)."""
    g = torch.Generator(device=dev).manual_seed(2)
    buf = torch.randn(1 + 6 * 7 * 16, generator=g, device=dev).to(BF16)
    level = buf[1:].view(6, 7, 16)
    ix, iy = _coords(g, [level], 300, dev)
    torch.testing.assert_close(gather_levels([level], ix, iy),
                               gather_levels_plain([level], ix, iy), rtol=0, atol=0)
    with pytest.raises(ValueError, match="one dtype"):
        gather_levels([level, level.float()], torch.cat([ix, ix]), torch.cat([iy, iy]))
    with pytest.raises(ValueError, match="f32 or bf16"):  # no f16 instantiation
        gather_levels([level.half()], ix, iy)


@pytest.mark.parametrize("case", ["pyramid", "tiny", "image", "contended", "misaligned"])
def test_gather_bwd_kernel_bf16_matches_plain(dev, case):
    """Kernel G-bwd's bf16 instantiation: the bf16 cotangent read and
    converted exactly, f32 atomics into f32 gradient buffers (rtol 1e-5
    against the plain backward's f32 sums), the run-merging mapping at the
    KITTI widths ("pyramid": 2001 points), the per-point vector and scalar
    paths, coordinate gradients in f32 (rtol 1e-4) on a 3-channel bf16
    image, and a small level every point lands on."""
    g = torch.Generator(device=dev).manual_seed(11)
    widths = {"pyramid": (80, 160, 320, 640, 1280), "tiny": (2, 4, 8, 16, 32), "image": (3,),
              "contended": (1280,), "misaligned": (16,)}[case]
    n = {"pyramid": 2001, "contended": 20000}.get(case, 1500)
    if case == "contended":
        levels = [torch.randn(3, 4, 1280, generator=g, device=dev).to(BF16)]
    elif case == "misaligned":
        buf = torch.randn(1 + 9 * 13 * 16, generator=g, device=dev).to(BF16)
        levels = [buf[1:].view(9, 13, 16)]
    else:
        levels = [torch.randn(9 + i, 13 + 2 * i, c, generator=g, device=dev).to(BF16)
                  for i, c in enumerate(widths)]
    ix, iy = _coords(g, levels, n, dev)
    d_out = torch.randn(n, sum(widths), generator=g, device=dev).to(BF16)
    coords = case == "image"
    got = [torch.zeros(lv.shape, device=dev) for lv in levels]
    want = [torch.zeros(lv.shape, device=dev) for lv in levels]
    build.reset_launch_counts()
    got_xy = G.gather_levels_backward(levels, ix, iy, d_out, got, coords)
    want_xy = G._plain_backward(levels, ix, iy, d_out, want, coords)
    torch.cuda.synchronize()
    assert build.LAUNCHES["gather_levels_bwd_bf16"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    if coords:
        for a, b in zip(got_xy, want_xy):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    with pytest.raises(ValueError, match="cotangent"):
        G.gather_levels_backward(levels, ix, iy, d_out.float(), got, False)


def test_gather_bf16_autograd_casts_once_per_pyramid(dev):
    """Gathers on a bf16 pyramid through its shared buffers: the level
    gradients reach autograd as bf16, each the f32 buffer's sum rounded
    once (equal to the plain gathers' f32 sums, rounded, within one bf16
    spacing, beside the f32 sums' own differences), and the gathers' own
    outputs bf16."""
    g = torch.Generator(device=dev).manual_seed(4)
    widths = (80, 160, 320, 640, 1280)
    base = [torch.randn(6 + 3 * i, 9 + 4 * i, c, generator=g, device=dev).to(BF16)
            for i, c in enumerate(widths)]
    xy = [_coords(g, base, n, dev) for n in (1200, 300, 700)]
    cots = [torch.randn(x.shape[1], sum(widths), generator=g, device=dev).to(BF16)
            for x, _ in xy]
    leaves = [lv.clone().requires_grad_(True) for lv in base]
    pyramid, pgrads = G.share_pyramid_grads(leaves)
    outs = [gather_levels(pyramid, x, y, grads=pgrads) for x, y in xy]
    assert all(o.dtype == BF16 for o in outs)
    torch.autograd.backward(outs, cots)
    want = [torch.zeros(lv.shape, device=dev) for lv in base]
    for (x, y), cot in zip(xy, cots):
        G._plain_backward(base, x, y, cot, want, False)
    torch.cuda.synchronize()
    for lv, w in zip(leaves, want):
        assert lv.grad.dtype == BF16
        # one bf16 rounding (2^-7 relative at most) of sums that differ in
        # their f32 order (atol 1e-5 of the largest, as in f32)
        torch.testing.assert_close(lv.grad.float(), w, rtol=2.0 ** -7,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["identity", "silu", "leaky"])
@pytest.mark.parametrize("M,C", [(1, 80), (7, 3), (1000, 12), (2501, 80), (468, 3840),
                                 (4514, "channel-first")])
def test_bn_kernels_bf16_match_plain(dev, M, C, act, res, training):
    """Kernel K5's bf16 instantiation (N1-N4 with bf16 x, residual, y, dy,
    dx, d_residual; f32 statistics, parameter gradients and running
    statistics) against the plain bf16 version and its autograd, which round
    at the same points: y within one bf16 spacing (2^-7 relative) beside the
    f32 statistics' own differences (atol 1e-6 of the summands |x mul| + |y|
    + |r|: where z cancels to near 0 they move its rounding), running
    statistics rtol 1e-5, dweight and dbias relative L2 <= 1e-4 (f32 sums of the same
    products), dx and d_residual <= BF16_DX_REL_L2; 8 channels a vector (C =
    80, 3840), the scalar path (C = 3, 12), M = 1 and a channel-first input."""
    if C == "channel-first":
        g = torch.Generator(device=dev).manual_seed(24)
        cf = lambda: torch.randn(2, 24, 37, 61, generator=g, device=dev).permute(0, 2, 3, 1)  # noqa: E731
        x, r, dy = cf() * 2 + 0.5, cf(), cf()
        C = 24
        w, b, rv = (torch.rand(C, generator=g, device=dev) + 0.5 for _ in range(3))
        rm = torch.rand(C, generator=g, device=dev) * 0.4 - 0.2
    else:
        x, w, b, rm, rv, r, dy = _bn_inputs(dev, M, C, True, seed=5)
    x, r, dy = (t.to(BF16) for t in (x, r, dy))
    r = r if res else None
    got, want, launches = _bn_both(x, w, b, rm, rv, r, dy, training, act)
    n_stats = int(training)
    assert (launches["bn_stats_bf16"], launches["bn_apply_bf16"], launches["bn_bwd_reduce_bf16"],
            launches["bn_bwd_apply_bf16"]) == (n_stats, 1, 1, 1), launches
    y, rm_k, rv_k, dx, dw, db, dr = got
    y0, rm_p, rv_p, dx0, dw0, db0, dr0 = want
    assert y.dtype == dx.dtype == BF16 and dw.dtype == torch.float32
    assert y.stride() == x.stride()
    var = x.float().reshape(-1, C).var(0, unbiased=False) if training else rv
    mul = float((w * torch.rsqrt(var + 1e-5)).abs().max())
    scale = float(x.float().abs().max()) * mul + float(y0.float().abs().max()) + (
        0.0 if r is None else float(r.float().abs().max()))
    torch.testing.assert_close(y.float(), y0.float(), rtol=2.0 ** -7, atol=1e-6 * scale)
    for a, b_ in ((rm_k, rm_p), (rv_k, rv_p)):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6 * float(b_.abs().max()))
    one_row = x[..., 0].numel() == 1
    for a, b_, tol in ((dw, dw0, 1e-4), (db, db0, 1e-4), (dx, dx0, BF16_DX_REL_L2),
                       (dr, dr0, BF16_DX_REL_L2)):
        if b_ is None:
            assert a is None
            continue
        assert bool(torch.isfinite(a.float()).all())
        if one_row and b_ is not db0:  # 0 up to rounding: held to the terms' scale
            floor = float(dy.float().norm()) * float(w.abs().max() / (rv.min() + 1e-5) ** 0.5)
            assert float((a.float() - b_.float()).norm()) <= tol * floor
            continue
        assert _rel_l2(a.float(), b_.float(), 0.0) <= tol, (M, C, act, res, training)


def test_tiny_bf16_train_step_on_card(dev):
    """One `tiny` bf16 training step on the card (kernels G, G-bwd and K5 in
    bf16, C / C-bwd / S in f32) against the same step on the CPU (the plain
    bf16 versions; the convolutions and products there are the CPU's bf16
    ones): loss within 5e-3, every gradient f32 and finite, and the bf16
    instantiations launched (the reprojection gathers on the f32 images
    stay f32)."""
    cfg = C.tiny(compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = SceneRF(cfg)
    cpu = Trainer(cfg, device="cpu", model=model)
    card = Trainer(cfg, device=dev, model=SceneRF(cfg))
    card.model.load_state_dict(model.state_dict())
    batch = make_batch(cfg, seed=1)
    noise = model.draw_noise(1, cfg.n_sources, torch.Generator().manual_seed(4), "cpu")
    build.reset_launch_counts()
    got = card.train_step(batch, noise={k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    for k in ("gather_levels", "gather_levels_bwd"):
        assert 1 <= build.LAUNCHES[f"{k}_bf16"] < build.LAUNCHES[k], build.LAUNCHES
    assert all(build.LAUNCHES[k] >= 1 for k in ("sort_composite", "sort_composite_bwd"))
    want = cpu.train_step(batch, noise=noise)
    torch.testing.assert_close(got["total_loss"].cpu(), want["total_loss"], rtol=5e-3, atol=0)
    for name, p in card.model.named_parameters():
        assert p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all()), name
