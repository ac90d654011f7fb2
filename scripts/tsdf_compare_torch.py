"""Kernel T (TSDF fusion) of this checkout beside an earlier version of its
source, at the three shapes the reconstruction paths launch it with, on one
NVIDIA GPU; and what the work of each shape is.

    git archive <commit> scenerf_tpu_torch/ops/csrc | tar -x -C build/baseline
    python3 scripts/tsdf_compare_torch.py \\
        --baseline build/baseline/scenerf_tpu_torch/ops/csrc \\
        [--stride 2] [--out build/tsdf_compare/report] [--variants ...]

The baseline directory holds an earlier `tsdf.cu` (and `common.cuh`) with
the C entry `scenerf_tsdf_integrate_f32` this checkout's has. It is built
with the package's nvcc flags into its own library under build/, and so is
this checkout's. By default only these two are compared. --variants adds
variants for timing only, each a patch of one kernel's source:
"this_no_cull" (every frame live) and "this_compute_only" (the depth and
color gathers replaced by loads of the first 256 pixels, which stay in L1)
patch this checkout's; "earlier_compute_only" (the same) and "earlier_rcp"
(the two divisions by the camera depth replaced by a multiply with its
approximate reciprocal) patch the one-thread-per-voxel kernel of commit
6c607e3 and earlier, and refuse any other baseline.

Shapes (f32, closest mode, the CLIs'):
- KITTI: chip_smoke.py phase 11's arrays, a seeded random `kitti()` model's
  63-pose sweep of its synthetic frame at --stride, upsampled to 1220x370,
  into the 256x256x32 grid at 0.2 m;
- BF sweep: 33 frames at `bf_rel_poses(30, 0.2, 2.1)`, 640x480, the depth
  and colors `scripts/make_fake_bf.py` writes (a 1-4 m room), into the
  120x120x96 grid at 0.04 m;
- BF GT: 16 such frames from cameras 0.05 m apart along the view axis (the
  fake tree's poses), into the same grid.

Per shape: the work (chip_smoke.tsdf_footprint: voxel-frames in view and
valid, distinct depth pixels and taken colors, distinct 32-B sectors per
warp depth load under the earlier mapping and this one's; chip_smoke.
tsdf_cull: the share this kernel's tiles keep), each kernel's time alone
(CUDA graph of 50 launches) and by events on a fresh volume (median of 20),
in the order earlier, this, this, earlier, the variants once, and the bounds
(chip_smoke.tsdf_bounds). This kernel is checked bit-equal to the earlier
one in both modes, every voxel. Each library's SASS (cuobjdump) goes to
--out, with each kernel's instruction count and the instructions of each
loop (the span of each backward branch); ptxas' registers and spills too.
Prints one line per shape and writes everything to --out/tsdf_compare.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 0

# timing-only variants: substitutions (old, new, count) in a kernel's source
PR3_CONST = [("fr.depths[pix]", "fr.depths[pix & 255]", 1),
             ("c = fr.colors[pix]", "c = fr.colors[pix & 255]", 1),
             ("unpack_rgb(fr.colors[pix], new_rgb)", "unpack_rgb(fr.colors[pix & 255], new_rgb)", 1)]
PR3_RCP = [("    const float px = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(K[0], cx), sz), K[2]));\n",
            "    const float rz = __fdividef(1.0f, sz);\n"
            "    const float px = rintf(__fadd_rn(__fmul_rn(__fmul_rn(K[0], cx), rz), K[2]));\n", 1),
           ("__fdiv_rn(__fmul_rn(K[4], cy), sz)", "__fmul_rn(__fmul_rn(K[4], cy), rz)", 1)]
NO_CULL = [("const bool live = f < fr.F && quarter == 0 && !unseen;",
            "const bool live = f < fr.F && quarter == 0;", 1)]
THIS_CONST = [("__ldg(dmap + off[e])", "__ldg(fr.depths + (off[e] & 255))", 1),
              ("__ldg(cmap + off[e])", "__ldg(fr.colors + (off[e] & 255))", 2)]


def patched(src: str, subs) -> str:
    for old, new, n in subs:
        if src.count(old) != n:
            raise RuntimeError(f"expected {n} of {old!r} in the source, found {src.count(old)}")
        src = src.replace(old, new)
    return src


def build_libs(variants: dict, out_dir: Path) -> dict:
    """variants: name -> (csrc dir, substitutions). One nvcc per variant, all
    started together; returns name -> (CDLL, .so path, ptxas log)."""
    from scenerf_tpu_torch.ops import build

    nvcc = build._nvcc()
    procs = {}
    for name, (csrc, subs) in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "common.cuh", d / "common.cuh")
        (d / "tsdf.cu").write_text(patched((csrc / "tsdf.cu").read_text(), subs))
        so = d / "libtsdf.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(d / "tsdf.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.scenerf_tsdf_integrate_f32.argtypes = [vp] * 7 + [i32] * 6 + [f32] * 6 + [i32, vp]
        lib.scenerf_tsdf_integrate_f32.restype = i32
        libs[name] = (lib, so, log)
    return libs


def sass_summary(so: Path, cuobjdump: str, out: Path) -> dict:
    """Each kernel's SASS instruction count and the span of each backward
    branch (a loop: its first and last address and its instructions)."""
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out.write_text(text)
    funcs = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = [(int(a, 16), body.strip()) for a, body in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*;)", block)]
        addr = [a for a, _ in ins]
        loops = []
        for a, body in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", body)
            if m and int(m.group(1), 16) <= a:
                lo = int(m.group(1), 16)
                loops.append({"from": hex(lo), "to": hex(a),
                              "instructions": sum(lo <= x <= a for x in addr)})
        funcs[name] = {"instructions": len(ins), "loops": loops}
    return funcs


def kitti_arrays(dev, stride: int):
    """chip_smoke.py phase 11's arrays (its recipe, at `stride`)."""
    import torch

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.data.synthetic import input_frame, kitti_calibration
    from scenerf_tpu_torch.fusion.tsdf import pack_colors
    from scenerf_tpu_torch.model import SceneRF, compute_sphere_maps

    cfg = C.kitti()
    torch.manual_seed(SEED)
    with torch.device(dev):
        model = SceneRF(cfg).eval()
    K_kitti, T_velo_2_cam = kitti_calibration()
    rel_poses = geo.rel_pose_stack(geo.sample_rel_poses(
        cfg.sweep_step, cfg.sweep_angle, cfg.sweep_max_distance))
    frame = torch.from_numpy(input_frame(cfg, seed=SEED)).to(dev)
    with torch.no_grad():
        lv = model.encode(frame, K_kitti, sphere_maps=compute_sphere_maps(cfg, K_kitti))
        sweep = recon.render_sweep_full_res(model, model.pyramid_for_item(lv, 0),
                                            torch.from_numpy(K_kitti).to(dev),
                                            torch.from_numpy(rel_poses).to(dev), stride=stride,
                                            chunk=5000, seed=SEED)
    depths, colors = sweep["depth"], recon.quantize_colors(sweep["color"])
    del model, lv, sweep
    torch.cuda.empty_cache()
    cam_poses = np.stack([np.linalg.inv(T_velo_2_cam) @ p for p in rel_poses])
    w2cs = np.stack([np.linalg.inv(p) for p in cam_poses]).astype(np.float32)
    vol = recon.kitti_volume(dev)
    return dict(depths=depths.contiguous(), packed=pack_colors(colors),
                intrs=torch.from_numpy(np.tile(K_kitti[None], (len(w2cs), 1, 1))).to(dev),
                w2cs=torch.from_numpy(w2cs).to(dev), shape=vol.shape,
                origin=vol._vol_origin, voxel=vol._voxel_size, trunc=vol._trunc_margin)


def bf_arrays(dev, poses):
    """Frames of make_fake_bf.py's room at 640x480 (its depth, quantized to
    mm, and colors) at the given camera -> grid poses, into the BF grid."""
    import torch

    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.fusion.tsdf import pack_colors

    W, H = 640, 480
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (2500 + 1500 * np.sin(xx / (W / 4.0)) * np.sin(yy / (H / 4.0))).astype(np.uint16)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 13.0), 0.5 + 0.4 * np.sin(yy / 19.0),
                    0.5 + 0.4 * np.sin((xx + yy) / 29.0)], -1)
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8).astype(np.float32)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
    n = len(poses)
    w2cs = np.stack([np.linalg.inv(np.asarray(p)) for p in poses]).astype(np.float32)
    vol = recon.bf_volume(dev)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return dict(depths=f32(np.broadcast_to(depth.astype(np.float32) / 1000.0, (n, H, W))),
                packed=pack_colors(f32(np.broadcast_to(rgb, (n, H, W, 3)))),
                intrs=f32(np.broadcast_to(K, (n, 3, 3))), w2cs=f32(w2cs), shape=vol.shape,
                origin=vol._vol_origin, voxel=vol._voxel_size, trunc=vol._trunc_margin)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, help="csrc directory of the earlier kernel")
    ap.add_argument("--stride", type=int, default=2, help="render stride of the KITTI sweep")
    ap.add_argument("--out", default="build/tsdf_compare/report")
    ap.add_argument("--variants", default="",
                    help="timing-only variants to build, comma-separated (default: none)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from scenerf_tpu_torch.cli import reconstruction as rc
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import tsdf as T

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    this = ROOT / "scenerf_tpu_torch" / "ops" / "csrc"
    base = Path(args.baseline)
    variants = {"earlier": (base, []), "earlier_compute_only": (base, PR3_CONST),
                "earlier_rcp": (base, PR3_RCP), "this": (this, []),
                "this_no_cull": (this, NO_CULL), "this_compute_only": (this, THIS_CONST)}
    extra = [k for k in args.variants.split(",") if k]
    unknown = [k for k in extra if k not in variants or k in ("earlier", "this")]
    if unknown:
        sys.exit(f"unknown variants {unknown}; choose from "
                 f"{[k for k in variants if k not in ('earlier', 'this')]}")
    libs = build_libs({k: variants[k] for k in ["earlier", "this", *extra]},
                      ROOT / "build" / "tsdf_compare")
    report = {"card": card, "ptxas": {}, "sass": {}, "shapes": {}}
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    for name, (_, so, log) in libs.items():
        report["ptxas"][name] = [ln for ln in log.splitlines() if "registers" in ln
                                 or "spill" in ln]
        report["sass"][name] = sass_summary(so, cuobjdump, out_dir / f"sass_{name}.txt")
        for fn, s in report["sass"][name].items():
            print(f"[sass] {name} {fn[:60]}: {s['instructions']} instructions; loops "
                  + ", ".join(f"{lp['from']}-{lp['to']} {lp['instructions']}"
                              for lp in s["loops"]), flush=True)
        print(f"[ptxas] {name}: " + " | ".join(report["ptxas"][name]), flush=True)

    def call(name, vols, a, mode=0):
        lib = libs[name][0]
        F_, H, W = a["depths"].shape
        X, Y, Z = a["shape"]
        o = T._origin_values(a["origin"])
        st = lib.scenerf_tsdf_integrate_f32(
            *(v.data_ptr() for v in vols), a["depths"].data_ptr(), a["packed"].data_ptr(),
            a["intrs"].data_ptr(), a["w2cs"].data_ptr(), F_, H, W, X, Y, Z, *o,
            float(a["voxel"]), float(a["trunc"]), 1.0, mode, build.stream_handle(dev))
        if st:
            raise RuntimeError(f"{name}: launch failed ({st})")

    def fresh(shape):
        return [torch.full(shape, 255.0, device=dev), torch.zeros(shape, device=dev),
                torch.zeros(shape, device=dev)]

    def timed_fresh(name, a, runs=cs.TIMING_RUNS):
        work = fresh(a["shape"])
        times = []
        for i in range(runs + 1):
            work[0].fill_(255.0)
            work[1].zero_()
            work[2].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(name, work, a)
            end.record()
            end.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    def alone(name, a):
        work = fresh(a["shape"])
        return cs.graph_ms(lambda: call(name, work, a))

    makers = {
        "kitti": lambda: kitti_arrays(dev, args.stride),
        "bf_sweep": lambda: bf_arrays(dev, list(rc.bf_rel_poses(30.0, 0.2, 2.1).values())),
        "bf_gt": lambda: bf_arrays(dev, [np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                                   [0, 0, 1, 0.05 * d], [0, 0, 0, 1]])
                                         for d in list(range(-8, 0)) + list(range(1, 9))]),
    }
    for shape_name, make in makers.items():
        a = make()
        F_, H, W = a["depths"].shape
        # this kernel against the earlier, every voxel, both modes
        for mode in (0, 1):
            got, want = fresh(a["shape"]), fresh(a["shape"])
            call("this", got, a, mode)
            call("earlier", want, a, mode)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{shape_name} mode {mode}: this kernel differs from the "
                                       f"earlier one on {int((g != w).sum())} voxels")
        cull = cs.tsdf_cull(a["shape"], a["origin"], a["voxel"], a["intrs"], a["w2cs"], H, W)
        groups = cs.tsdf_warp_groups(a["shape"], cull["lane_axis"])
        fp = cs.tsdf_footprint(a["shape"], a["origin"], a["voxel"], a["trunc"], a["depths"],
                               a["packed"], a["intrs"], a["w2cs"], groups)
        b = cs.tsdf_bounds(fp, 3 * 4 * fp["n_voxels"], cs.nbytes(a["depths"], a["packed"]),
                           cs.nbytes(a["intrs"], a["w2cs"]))
        times = {"earlier": [], "this": []}
        for name in ("earlier", "this", "this", "earlier"):
            times[name].append((timed_fresh(name, a), alone(name, a)))
        for name in extra:
            times[name] = [(timed_fresh(name, a), alone(name, a))]
        ms = {k: {"events_ms": statistics.mean(t[0] for t in v),
                  "alone_ms": statistics.mean(t[1] for t in v),
                  "runs": [list(t) for t in v]} for k, v in times.items()}
        sectors = {k: fp["sectors"][k] / max(fp["loads"][k], 1) for k in groups}
        report["shapes"][shape_name] = dict(shape=[*a["shape"], F_, H, W], footprint=fp,
                                            cull=cull, sectors_per_load=sectors, bounds=b,
                                            times=ms)
        print(f"[{shape_name}] {[*a['shape'], F_, H, W]}: {cs.tsdf_work_text(fp, b, cull)}; "
              "32-B sectors per warp depth load "
              + ", ".join(f"{k} {v:.2f}" for k, v in sectors.items()), flush=True)
        print(f"[{shape_name} times] " + "; ".join(
            f"{k} {v['events_ms']:.4f} ms events, {v['alone_ms']:.4f} alone" for k, v in ms.items()),
            flush=True)
        del a
        torch.cuda.empty_cache()
    (out_dir / "tsdf_compare.json").write_text(json.dumps(report, indent=1))
    print(f"wrote {out_dir / 'tsdf_compare.json'}")


if __name__ == "__main__":
    main()
