"""Kernels G and G-bwd of this checkout beside an earlier version of their
sources, at every shape the KITTI paths launch them with, on one NVIDIA GPU.

    git archive <commit> scenerf_tpu_torch/ops/csrc | tar -x -C build/baseline
    python3 scripts/gather_compare_torch.py \
        --baseline build/baseline/scenerf_tpu_torch/ops/csrc [--out build/gather_compare.json]

The baseline directory holds an earlier `gather.cu`, `gather_bwd.cu` and the
headers they include, with the C interface they had before lanes per point
and before G-bwd added into caller-zeroed gradients across launches:
`scenerf_gather_levels_f32(ptrs, hwcc, n_levels, ix, iy, n, out, cols,
stream)` and `scenerf_gather_levels_bwd_f32(vals, grads, hwcc, n_levels, ix,
iy, n, dout, cols, d_ix, d_iy, stream)`. They are built with the package's
nvcc flags into their own library under build/ and called through ctypes.

Shapes (f32, KITTI preset, B7): the field gather of a serve chunk (5000
consecutive stride-2 pixels x 64 samples, and phase 2's 5000 spread pixels),
of a training chunk (300 rays x 64) and of the GT-depth chunk (1024 x 64),
with their Gaussian anchors (4 per ray); the six sphere resamples (s1 .. s32
at B7's tap widths) and the reprojection gather (1200 pixels x 3). Backward:
the training chunk, its anchors and one source's 76,800 samples into the
pyramid, each resample into its tap, and the reprojection gather's coordinate
gradients. Each time is one launch's device time (CUDA-graph replay of
repeated launches, no host), taken in the order earlier, this, this, earlier
in one process; the old G-bwd with and without the zeroing of the level
gradients it needed per launch. Every result is checked: G bit-equal to the
plain version, G-bwd within 1e-5 of the largest level gradient. The bound is
chip_smoke.py's: bytes over 3.35 TB/s, counting the level rows the coords
touch once, the coords and the output (G-bwd: the cotangent, the touched
gradient rows read and written, and for coordinate gradients the touched
value rows). Beside this checkout's choice of mapping, its other choices
are timed where they apply: G with 1 or 4 rounds per warp, with or without
the cp.async ring (wide launches); G-bwd held to its per-point mapping
(where the run-merging one can serve). Prints one line per shape and writes all
numbers to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GATHER_BWD_REL_TOL = 1e-5
COORD_GRAD_REL_TOL = 1e-4


def build_baseline(csrc: Path) -> ctypes.CDLL:
    from scenerf_tpu_torch.ops import build

    out_dir = ROOT / "build" / "kernels_baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out_dir / f"{name}.o" for name in ("gather", "gather_bwd")]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", str(o),
                               str(csrc / f"{o.stem}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for o in objs]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the baseline:\n{out}")
    lib_path = out_dir / "libgather_baseline.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.scenerf_gather_levels_f32.argtypes = [vp, vp, i32, vp, vp, i32, vp, i32, vp]
    lib.scenerf_gather_levels_bwd_f32.argtypes = [vp, vp, vp, i32, vp, vp, i32, vp, i32,
                                                  vp, vp, vp]
    lib.scenerf_gather_levels_f32.restype = i32
    lib.scenerf_gather_levels_bwd_f32.restype = i32
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, help="csrc directory of the earlier kernels")
    ap.add_argument("--out", default="build/gather_compare.json")
    ap.add_argument("--reps", type=int, default=20, help="launches per CUDA graph")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch import sampling as S
    from scenerf_tpu_torch.data.synthetic import default_intrinsics
    from scenerf_tpu_torch.encoder.sphere_decoder import sphere_map_coords
    from scenerf_tpu_torch.model import compute_sphere_maps
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import gather as G
    from scenerf_tpu_torch.rendering import SCALES, inverse, pyramid_coords, pyramid_level_size

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    new = build.library()
    old = build_baseline(Path(args.baseline))
    stream = lambda: build.stream_handle(dev)  # noqa: E731  (the capture stream in a graph)

    def graph_ms(fn) -> float:
        return cs.graph_ms(fn, reps=args.reps)

    def pair(old_fn, new_fn):
        """(earlier ms, this ms): each the mean of two graph timings, taken in
        the order earlier, this, this, earlier."""
        o1, n1, n2, o2 = graph_ms(old_fn), graph_ms(new_fn), graph_ms(new_fn), graph_ms(old_fn)
        return (o1 + o2) / 2, (n1 + n2) / 2, [o1, n1, n2, o2]

    def fwd_call(lib, levels, ix, iy, out, rounds_async=None):
        """Kernel G into a preallocated output (this checkout's with the
        wrapper's launch arguments, or with (rounds, async_wide) given)."""
        n_levels, n = ix.shape
        hwcc, width, lanes, *choice = G.forward_launch_args(levels, n)
        choice = [lanes, *(rounds_async or choice)]
        ptrs = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
        tail = [stream()] if lib is old else [*choice, stream()]
        st = lib.scenerf_gather_levels_f32(ptrs, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(),
                                           n, out.data_ptr(), width, *tail)
        if st:
            raise RuntimeError(f"gather launch failed: {st}")

    def bwd_call(lib, levels, ix, iy, dout, grads, dxy=(None, None), zero=False,
                 per_point=False):
        """The earlier G-bwd (zeroing its gradients first where `zero`), or
        this checkout's through its wrapper (or held to its per-point
        mapping)."""
        if lib is new and not per_point:
            return G.gather_levels_backward(levels, ix, iy, dout, grads, dxy[0] is not None)
        n_levels, n = ix.shape
        hwcc, width, lanes = G._level_meta(levels, n)
        if zero:
            for g in grads:
                if g is not None:
                    g.zero_()
        vals = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
        gp = (ctypes.c_void_p * n_levels)(*[build.ptr(g) for g in grads])
        tail = [lanes, 1, stream()] if per_point else [stream()]
        st = lib.scenerf_gather_levels_bwd_f32(vals, gp, hwcc, n_levels, ix.data_ptr(),
                                               iy.data_ptr(), n, dout.data_ptr(), width,
                                               build.ptr(dxy[0]), build.ptr(dxy[1]), *tail)
        if st:
            raise RuntimeError(f"gather_bwd launch failed: {st}")

    cfg = C.kitti()
    K_np = default_intrinsics(cfg)
    K = torch.from_numpy(K_np).to(dev)
    inv_K = inverse(K)
    gen = torch.Generator(device=dev).manual_seed(0)
    W, H = cfg.img_size
    widths = [cfg.encoder_features // k for k in (32, 16, 8, 4, 2)]
    levels = [torch.randn(*pyramid_level_size(cfg.sphere, s), c, generator=gen, device=dev)
              for s, c in zip(SCALES, widths)]
    pose = torch.from_numpy(geo.sample_rel_poses(0.5, 10.0, 1.0)[(0.5, 10.0)]).to(dev)
    grid = geo.pixel_grid(W, H, device=dev)
    grid2 = grid[(grid[:, 0] % 2 == 0) & (grid[:, 1] % 2 == 0)]
    grid2 = grid2[torch.argsort(grid2[:, 1] * W + grid2[:, 0])]  # x fastest, as the sweep

    def coords_of(pix, n_samples):
        pts, _, _, _ = S.sample_rays_uniform(gen, pix, inv_K, pose, n_samples,
                                             cfg.min_sample_depth, cfg.max_sample_depth)
        return pyramid_coords(pts.reshape(-1, 3), K, inv_K, cfg.sphere,
                              [lv.shape[:2] for lv in levels])

    mid = grid2.shape[0] // 2
    serve_pix = grid2[mid:mid + 5000]
    spread_pix = grid2[torch.linspace(0, grid2.shape[0] - 1, 5000, device=dev).long()]
    train_pix = S.random_grid_pixels(gen, cfg.n_rays, W, H, stride=cfg.pixel_stride,
                                     grid_size=cfg.sample_grid_size, device=dev)
    G_ = cfg.n_gaussians
    pyramid_shapes = {
        "serve chunk 5000 x 64": coords_of(serve_pix, 64),
        "phase-2 spread 5000 x 64": coords_of(spread_pix, 64),
        "serve anchors 5000 x 4": coords_of(serve_pix, G_),
        "GT-depth chunk 1024 x 64": coords_of(train_pix[:1024], 64),
        "train chunk 300 x 64": coords_of(train_pix[:cfg.ray_chunk], 64),
        "train anchors 300 x 4": coords_of(train_pix[:cfg.ray_chunk], G_),
    }
    rows = []

    def report(row):
        rows.append(row)
        print(f"[{row['kernel']}] {row['shape']} ({row['lanes']} lanes per point): earlier "
              f"{row['earlier_ms']:.4f} ms"
              + (f" (zeroing included {row['earlier_with_zeroing_ms']:.4f})"
                 if "earlier_with_zeroing_ms" in row else "")
              + f", this {row['this_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms"
              + f" ({row['this_ms'] / row['bound_ms']:.2f}x); err {row['max_abs_err']:.2e}"
              + "".join(f"; {k} {v:.4f}" for k, v in row.get("other_choices_ms", {}).items()),
              flush=True)

    def fwd_case(name, lvs, ix, iy):
        n = ix.shape[1]
        width = sum(lv.shape[2] for lv in lvs)
        out_old = torch.empty(n, width, device=dev)
        out_new = torch.empty(n, width, device=dev)
        fwd_call(old, lvs, ix, iy, out_old)
        fwd_call(new, lvs, ix, iy, out_new)
        want = G.gather_levels_plain(lvs, ix, iy)
        torch.cuda.synchronize()
        if not (torch.equal(out_new, want) and torch.equal(out_old, want)):
            raise SystemExit(f"G at {name}: not bit-equal to the plain version "
                             f"(this {float((out_new - want).abs().max())}, "
                             f"earlier {float((out_old - want).abs().max())})")
        del want
        o, t, runs = pair(lambda: fwd_call(old, lvs, ix, iy, out_old),
                          lambda: fwd_call(new, lvs, ix, iy, out_new))
        _, _, lanes, rounds, async_wide = G.forward_launch_args(lvs, n)
        row = dict(kernel="G", shape=name, points=n, width=width, lanes=lanes, rounds=rounds,
                   async_wide=async_wide, earlier_ms=o, this_ms=t, runs=runs, max_abs_err=0.0,
                   **cs.bound(cs.touched_row_bytes(lvs, ix, iy) + cs.nbytes(ix, iy, out_new), 0))
        if lanes == 32 and max(lv.shape[2] for lv in lvs) >= 160:
            # the other launch choices of this checkout's G, each bit-equal too
            row["other_choices_ms"] = {}
            for ra in ((1, 0), (1, 1), (4, 0)):
                if ra == (rounds, async_wide):
                    continue
                out_new.zero_()
                fwd_call(new, lvs, ix, iy, out_new, ra)
                torch.cuda.synchronize()
                if not torch.equal(out_new, out_old):
                    raise SystemExit(f"G with rounds, async_wide = {ra} at {name}: not bit-equal")
                row["other_choices_ms"][f"rounds {ra[0]}, async_wide {ra[1]}"] = graph_ms(
                    lambda: fwd_call(new, lvs, ix, iy, out_new, ra))
        report(row)
        del out_old, out_new

    for name, (ix, iy) in pyramid_shapes.items():
        fwd_case(f"pyramid, {name}", levels, ix, iy)

    sphere_maps = compute_sphere_maps(cfg, K_np)
    tap_widths = {1: 3, 2: 32, 4: 48, 8: 80, 16: 224, 32: cfg.encoder_features}
    taps = {}
    for s, c in tap_widths.items():
        tap = torch.randn(-(-H // s), -(-W // s), c, generator=gen, device=dev)
        rix, riy = sphere_map_coords(torch.from_numpy(sphere_maps[s]).to(dev), *tap.shape[:2])
        taps[s] = (tap, rix[None].contiguous(), riy[None].contiguous())
        fwd_case(f"sphere resample s{s} {tuple(tap.shape)} -> {sphere_maps[s].shape[:2]}",
                 [tap], *taps[s][1:])
    img = torch.rand(H, W, 3, generator=gen, device=dev)
    span = torch.tensor([W + 40.0, H + 40.0], device=dev)
    pix_img = torch.rand(cfg.n_rays, 2, generator=gen, device=dev) * span - 20.0
    px, py = geo.pix_feature_coords(pix_img, H, W)
    px, py = px[None].contiguous(), py[None].contiguous()
    fwd_case(f"reprojection {cfg.n_rays} x 3", [img], px, py)

    # ---- G-bwd
    def bwd_case(name, lvs, ix, iy, coords=False, level_grads=True):
        n = ix.shape[1]
        width = sum(lv.shape[2] for lv in lvs)
        lanes = G.lanes_per_point([lv.shape[2] for lv in lvs], n)
        dout = torch.randn(n, width, generator=gen, device=dev)
        g_old = [torch.zeros_like(lv) if level_grads else None for lv in lvs]
        g_new = [torch.zeros_like(lv) if level_grads else None for lv in lvs]
        dxy_old = (torch.empty_like(ix), torch.empty_like(iy)) if coords else (None, None)
        bwd_call(old, lvs, ix, iy, dout, g_old, dxy_old)
        dxy_new = bwd_call(new, lvs, ix, iy, dout, g_new, dxy_old)
        per_point = level_grads and not coords and lanes == 32  # where run merging can serve
        g_pp = [torch.zeros_like(lv) for lv in lvs] if per_point else [None]
        if per_point:
            bwd_call(new, lvs, ix, iy, dout, g_pp, per_point=True)
        leaves = [lv.clone().requires_grad_(level_grads) for lv in lvs]
        cx, cy = ix.clone().requires_grad_(coords), iy.clone().requires_grad_(coords)
        wrt = [t for t in (*leaves, cx, cy) if t.requires_grad]
        want = torch.autograd.grad(G.gather_levels_plain(leaves, cx, cy), wrt, dout)
        torch.cuda.synchronize()
        errs = {}
        for which, got_set in (("earlier", [*g_old, *dxy_old]), ("this", [*g_new, *dxy_new]),
                               ("per-point mapping", g_pp)):
            got = [t for t in got_set if t is not None]
            for a, b in zip(got, want):
                tol = (COORD_GRAD_REL_TOL if a.shape == ix.shape else GATHER_BWD_REL_TOL)
                e = float((a - b).abs().max())
                if not e <= tol * float(b.abs().max()):
                    raise SystemExit(f"G-bwd ({which}) at {name}: max abs error {e}")
                errs[which] = max(errs.get(which, 0.0), e)
        del want, leaves
        touched = cs.touched_row_bytes(lvs, ix, iy)
        n_bytes = cs.nbytes(dout, ix, iy) + (2 * touched if level_grads else 0) \
            + (touched + cs.nbytes(ix, iy) if coords else 0)
        o, t, runs = pair(lambda: bwd_call(old, lvs, ix, iy, dout, g_old, dxy_old),
                          lambda: bwd_call(new, lvs, ix, iy, dout, g_new, dxy_new))
        row = dict(kernel="G-bwd", shape=name, points=n, width=width, lanes=lanes,
                   earlier_ms=o, this_ms=t, runs=runs, max_abs_err=errs["this"], errors=errs,
                   **cs.bound(n_bytes, 0))
        if level_grads:
            row["earlier_with_zeroing_ms"] = graph_ms(
                lambda: bwd_call(old, lvs, ix, iy, dout, g_old, dxy_old, zero=True))
        if per_point:
            row["other_choices_ms"] = {"per-point mapping": graph_ms(
                lambda: bwd_call(new, lvs, ix, iy, dout, g_pp, per_point=True))}
        report(row)

    for name in ("train chunk 300 x 64", "train anchors 300 x 4"):
        ix, iy = pyramid_shapes[name]
        bwd_case(f"pyramid, {name}", levels, ix, iy)
    ix, iy = coords_of(train_pix, 64)
    bwd_case("pyramid, one source 1200 x 64", levels, ix, iy)
    ix, iy = pyramid_shapes["serve anchors 5000 x 4"]
    bwd_case("pyramid, 5000 x 4 (the serve anchors' coords)", levels, ix, iy)
    for s, (tap, rix, riy) in taps.items():
        bwd_case(f"sphere resample s{s} {tuple(tap.shape)}", [tap], rix, riy)
    bwd_case(f"reprojection {cfg.n_rays} x 3, coords only", [img], px, py, coords=True,
             level_grads=False)

    print(f"card: {card}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "reps": args.reps, "rows": rows},
                                         indent=1))


if __name__ == "__main__":
    main()
