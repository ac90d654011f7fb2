"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the novel-depth
serve path at the full KITTI preset, through the hand-written kernels.

    python3 chip_smoke.py

Phases (each prints one line and raises on failure):
  1. device: card name and power limit, versions, TF32 off, kernel build
  2. kernel G (multi-level bilinear gather) against its plain PyTorch version
     at KITTI shapes: the five-level pyramid at the projected coords of
     5000 rays x 64 samples, and the s1/s2 sphere resample
  3. kernel C (per-ray sort + composite) against its plain version, R=5000, P=64
  4. encode: SceneRF(kitti()) with seeded random weights (EfficientNet-B7
     spherical U-Net) on one synthetic 1220x370 frame
  5. serve: render_pose_sweep over the first 3 poses of the CLI's default
     sweep at stride 2, chunk 5000; pose 0 again on the plain versions
  6. numbers: encode ms, ms per pose, rays/s, peak device memory
Then one JSON line of per-kernel results, the card line, and the last line
{"ok": true, "device": {...}}. It exits non-zero, printing no result, when no
CUDA device is present or any phase fails. Imports torch, numpy and the port
(`scenerf_tpu_torch`, which must sit beside this file), never JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_RAYS, N_PTS = 5000, 64
SWEEP_POSES = 3
STRIDE = 2
CHUNK = 5000
TIMING_RUNS = 20
GATHER_REL_TOL = 1e-5     # max abs error <= this x max|level|
COMPOSITE_RTOL = 1e-5
ARGMIN_MIN_SHARE = 0.999
SERVE_RTOL = 1e-3
SERVE_MIN_SHARE = 0.99


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of `fn` in ms over `runs` CUDA-event timed calls
    (after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not (ROOT / "scenerf_tpu_torch").is_dir():
        fail(f"the port package scenerf_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch import sampling as S
    from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
    from scenerf_tpu_torch.encoder.sphere_decoder import sphere_map_coords
    from scenerf_tpu_torch.model import SceneRF, compute_sphere_maps
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops.composite import sort_composite, sort_composite_plain
    from scenerf_tpu_torch.ops.gather import gather_levels, gather_levels_plain
    from scenerf_tpu_torch.rendering import (SCALES, pyramid_coords,
                                             pyramid_level_size)

    dev = torch.device("cuda", 0)

    # ---- 1. device -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"[1 device] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | kernels built+loaded in {build_s:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'reused'})")
    for line in build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    cfg = C.kitti()
    K_np = default_intrinsics(cfg)
    K = torch.from_numpy(K_np).to(dev)
    inv_K = torch.linalg.inv(K)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # ---- 2. kernel G -----------------------------------------------------
    widths = [cfg.encoder_features // k for k in (32, 16, 8, 4, 2)]
    levels = [torch.randn(*pyramid_level_size(cfg.sphere, s), c, generator=gen, device=dev)
              for s, c in zip(SCALES, widths)]
    W, H = cfg.img_size
    grid = geo.pixel_grid(W, H, device=dev)
    grid = grid[(grid[:, 0] % STRIDE == 0) & (grid[:, 1] % STRIDE == 0)]
    pix = grid[torch.linspace(0, grid.shape[0] - 1, N_RAYS, device=dev).long()]
    pose = torch.from_numpy(geo.sample_rel_poses(0.5, 10.0, 1.0)[(0.5, 10.0)]).to(dev)
    pts, _, _, _ = S.sample_rays_uniform(gen, pix, inv_K, pose, N_PTS,
                                         cfg.min_sample_depth, cfg.max_sample_depth)
    ix, iy = pyramid_coords(pts.reshape(-1, 3), K, inv_K, cfg.sphere,
                            [lv.shape[:2] for lv in levels])
    got = gather_levels(levels, ix, iy)
    want = gather_levels_plain(levels, ix, iy)
    torch.cuda.synchronize()
    scale = max(float(lv.abs().max()) for lv in levels)
    err = float((got - want).abs().max())
    if not err <= GATHER_REL_TOL * scale:
        fail(f"gather_levels: max abs error {err} > {GATHER_REL_TOL} x {scale}")
    ms = cuda_ms(lambda: gather_levels(levels, ix, iy))
    plain_ms = cuda_ms(lambda: gather_levels_plain(levels, ix, iy))
    results["gather_levels"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"[2 kernel G] pyramid {[tuple(lv.shape) for lv in levels]} at "
          f"{ix.shape[1]} points -> {tuple(got.shape)}: max abs err {err:.3e} "
          f"(limit {GATHER_REL_TOL * scale:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    sphere_maps = compute_sphere_maps(cfg, K_np)
    for s, c in ((1, 3), (2, 32)):
        tap = torch.randn(-(-H // s), -(-W // s), c, generator=gen, device=dev)
        m = torch.from_numpy(sphere_maps[s]).to(dev)
        rix, riy = sphere_map_coords(m, tap.shape[0], tap.shape[1])
        g1 = gather_levels([tap], rix[None], riy[None])
        g0 = gather_levels_plain([tap], rix[None], riy[None])
        torch.cuda.synchronize()
        rerr = float((g1 - g0).abs().max())
        if not rerr <= GATHER_REL_TOL * float(tap.abs().max()):
            fail(f"sphere resample s{s}: max abs error {rerr}")
        rms = cuda_ms(lambda: gather_levels([tap], rix[None], riy[None]))
        rplain = cuda_ms(lambda: gather_levels_plain([tap], rix[None], riy[None]))
        print(f"[2 kernel G] sphere resample s{s} {tuple(tap.shape)} -> "
              f"{tuple(m.shape[:2])}x{c}: max abs err {rerr:.3e}; kernel {rms:.3f} ms, "
              f"plain {rplain:.3f} ms")

    # ---- 3. kernel C -----------------------------------------------------
    n_uni = cfg.n_pts_uni
    sd_uni = S.uniform_sensor_distances(gen, N_RAYS, n_uni, cfg.min_sample_depth,
                                        cfg.max_sample_depth, device=dev)
    means = torch.rand(N_RAYS, cfg.n_gaussians, generator=gen, device=dev) * 100.0
    stds = torch.rand(N_RAYS, cfg.n_gaussians, generator=gen, device=dev) * 5.0 + 1.5
    sd_g = torch.clamp(torch.repeat_interleave(means, cfg.n_pts_per_gaussian, 1)
                       + torch.randn(N_RAYS, cfg.n_pts_gauss, generator=gen, device=dev)
                       * torch.repeat_interleave(stds, cfg.n_pts_per_gaussian, 1),
                       min=cfg.min_clamp_depth)  # clamped ties included
    sd = torch.cat([sd_uni, sd_g], 1)
    dv = sd * (0.8 + 0.2 * torch.rand(N_RAYS, 1, generator=gen, device=dev))
    dens = torch.nn.functional.softplus(
        torch.randn(N_RAYS, N_PTS, generator=gen, device=dev) - 1.0)
    rgb = torch.rand(N_RAYS, N_PTS, 3, generator=gen, device=dev)
    ck = sort_composite(sd, dv, dens, rgb)
    cp = sort_composite_plain(sd, dv, dens, rgb)
    torch.cuda.synchronize()
    cerr = 0.0
    for k in ("depth", "color"):
        ok = torch.isclose(ck[k], cp[k], rtol=COMPOSITE_RTOL, atol=1e-6)
        if not bool(ok.all()):
            fail(f"sort_composite {k}: {int((~ok).sum())} values beyond rtol {COMPOSITE_RTOL}")
        cerr = max(cerr, float((ck[k] - cp[k]).abs().max()))
    for k in ("sensor_distance", "depth_volume"):
        if not torch.equal(ck[k], cp[k]):
            fail(f"sort_composite {k}: sorted order differs from the stable sort")
    same_argmin = float((ck["closest_idx"] == cp["closest_idx"]).float().mean())
    if same_argmin < ARGMIN_MIN_SHARE:
        fail(f"sort_composite argmin agrees on {same_argmin:.4%} of rays")
    ms = cuda_ms(lambda: sort_composite(sd, dv, dens, rgb))
    plain_ms = cuda_ms(lambda: sort_composite_plain(sd, dv, dens, rgb))
    results["sort_composite"] = dict(max_abs_err=cerr, ms=ms, plain_ms=plain_ms)
    print(f"[3 kernel C] R={N_RAYS} P={N_PTS}: depth/color max abs err {cerr:.3e} "
          f"(rtol {COMPOSITE_RTOL}), argmin equal on {same_argmin:.4%} of rays; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del levels, ix, iy, got, want, ck, cp
    torch.cuda.empty_cache()

    # ---- 4. encode -------------------------------------------------------
    torch.manual_seed(SEED)
    with torch.device(dev):
        model = SceneRF(cfg).eval()
    img = torch.from_numpy(input_frame(cfg, seed=SEED)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv = model.encode(img, K_np, sphere_maps=sphere_maps)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    want_shapes = [(1, *pyramid_level_size(cfg.sphere, s), c) for s, c in zip(SCALES, widths)]
    got_shapes = [tuple(lv[k].shape) for k in ("1_1", "1_2", "1_4", "1_8", "1_16")]
    if got_shapes != want_shapes:
        fail(f"encode level shapes {got_shapes} != {want_shapes}")
    for k, v in lv.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"encode level {k} is not finite")
    print(f"[4 encode] B7 spherical U-Net on {W}x{H}: levels {got_shapes}, finite, "
          f"max|level| {['%.3e' % float(v.abs().max()) for v in lv.values()]}; "
          f"first call {encode_ms:.1f} ms")

    # ---- 5. serve --------------------------------------------------------
    pyramid = model.pyramid_for_item(lv, 0)
    poses_np = geo.rel_pose_stack(geo.sample_rel_poses(
        cfg.sweep_step, cfg.sweep_angle, cfg.sweep_max_distance))[:SWEEP_POSES]
    poses = torch.from_numpy(poses_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = model.render_pose_sweep(pyramid, K, poses, seed=SEED, stride=STRIDE,
                                    ray_chunk=CHUNK)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    depth, color = sweep["depth"], sweep["color"]
    if not (bool(torch.isfinite(depth).all()) and bool(torch.isfinite(color).all())):
        fail("sweep depth/color not finite")
    dmin, dmax = float(depth.min()), float(depth.max())
    if not (0.0 <= dmin and dmax <= cfg.max_sample_depth):
        fail(f"sweep depth range [{dmin}, {dmax}] outside [0, {cfg.max_sample_depth}]")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    n_rays = depth[0].numel()
    g0 = torch.Generator(device=dev).manual_seed(SEED)
    with build.plain_versions():
        ref = model.render_image(pyramid, K, poses[0], g0, stride=STRIDE, ray_chunk=CHUNK)
    shares = {}
    for k in ("depth", "color"):
        ok = torch.isclose(sweep[k][0], ref[k], rtol=SERVE_RTOL,
                           atol=SERVE_RTOL * float(ref[k].abs().max()))
        if k == "color":
            ok = ok.all(dim=-1)
        shares[k] = float(ok.float().mean())
        if shares[k] < SERVE_MIN_SHARE:
            fail(f"pose 0 {k}: kernel path agrees with the plain path on {shares[k]:.4%} of pixels")
    print(f"[5 serve] {SWEEP_POSES} poses x {tuple(depth.shape[1:])} = {n_rays} rays/pose, "
          f"chunk {CHUNK}: finite, depth in [{dmin:.3f}, {dmax:.3f}]; main-path launches "
          f"{launches}; pose 0 vs plain path within rtol {SERVE_RTOL}: depth "
          f"{shares['depth']:.4%}, color {shares['color']:.4%} of pixels")

    # ---- 6. numbers ------------------------------------------------------
    enc_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(img, K_np, sphere_maps=sphere_maps)
        torch.cuda.synchronize()
        enc_times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.render_pose_sweep(pyramid, K, poses, seed=SEED, stride=STRIDE, ray_chunk=CHUNK)
    torch.cuda.synchronize()
    warm_pose_ms = (time.perf_counter() - t0) * 1e3 / SWEEP_POSES
    print(f"[6 numbers] on {card}: encode {statistics.median(enc_times):.1f} ms "
          f"(median of 3 warm; first {encode_ms:.1f} ms); {warm_pose_ms:.1f} ms/pose warm "
          f"({sweep_ms / SWEEP_POSES:.1f} ms/pose in the first sweep); "
          f"{n_rays / warm_pose_ms * 1e3:.0f} rays/s; peak device memory "
          f"{peak / 2**30:.2f} GiB (encode + sweep)")

    sources = {"gather_levels": ("scenerf_tpu_torch/ops/csrc/gather.cu",
                                 "scenerf_tpu/geometry.py:106"),
               "sort_composite": ("scenerf_tpu_torch/ops/csrc/composite.cu",
                                  "scenerf_tpu/rendering.py:102")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in sources.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
