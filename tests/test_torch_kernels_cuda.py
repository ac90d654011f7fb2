"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the edge cases the KITTI-shaped smoke run does not reach: the scalar
channel loop (the `tiny` levels, a misaligned level), out-of-bounds coords,
fewer than 64 samples per ray, tied distances, and the `tiny` serve path on
the card against the same path on the CPU.

Marked `cuda`: skipped where no CUDA device is present (a CUDA kernel has no
CPU mode). The package under test imports no JAX, and neither does this
file, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.ops.composite import sort_composite, sort_composite_plain
from scenerf_tpu_torch.ops.gather import gather_levels, gather_levels_plain

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


def test_gather_kernel_misaligned_level(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn(1 + 6 * 7 * 8, generator=g, device=dev)
    level = buf[1:].view(6, 7, 8)  # contiguous, but 4 bytes off 16-byte alignment
    ix, iy = _coords(g, [level], 300, dev)
    torch.testing.assert_close(gather_levels([level], ix, iy),
                               gather_levels_plain([level], ix, iy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("P", [1, 20, 33, 64])
def test_sort_composite_kernel_matches_plain(dev, P):
    g = torch.Generator(device=dev).manual_seed(P)
    R = 777
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
    assert build.LAUNCHES == {"gather_levels": 1, "sort_composite": 1}
    with build.plain_versions():
        gather_levels([lv], xy, xy)
        sort_composite(sd, sd, sd, torch.rand(3, 8, 3, device=dev))
    assert build.LAUNCHES == {"gather_levels": 1, "sort_composite": 1}
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
