"""Kernels C and S of this checkout beside an earlier checkout's, at every
shape the KITTI paths launch them with, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/baseline
    python3 scripts/composite_compare_torch.py --baseline build/baseline \
        [--out build/composite_compare.json]

The earlier checkout's kernels are those before the block size was fixed
at 4 warps and the EM moved inside kernel C, with the C interface
`scenerf_sort_composite_f32(sd, dv, density, rgb, n, P, 10 outputs, order,
stream)` and `scenerf_ray_som_f32(means, stds, sd, alphas, n, C, P,
two_sigma2, c_floor, threshold, 3 outputs, stream)`.

Shapes (f32, KITTI preset: P = 64 samples, C = 4 Gaussians): the training
render's chunk of 300 rays with RaySOM (this checkout: one launch of C with
the EM inside; the earlier: C, then S on C's sorted samples) and without it,
both writing the sort order as the training launch does; the GT-depth
render's 1024 rays; a serve chunk of 5000 rays; the stride-2 sweep's last
chunk of 2850.

Two measurements, each in the order earlier, this, this, earlier:
- device time alone: one launch's device time (CUDA-graph replay of
  repeated launches on L2-resident inputs, no host), both kernel versions
  built into libraries of this process and called through ctypes. Beside
  this checkout's 4 warps per block, its C, its C with the EM inside and its
  standalone S are also built at 1, 2 and 8 warps per block (nvcc
  -DSCENERF_WARPS_PER_BLOCK=w) and timed once each, and an empty kernel on
  C's grid gives the floor of one launch. Every result is checked: this C's
  outputs bit-equal to the earlier C's, the EM outputs of the fused launch
  bit-equal to the earlier S's on the same sorted samples.
- the wrapper, host included: CUDA events around one call of each
  checkout's own Python entry, as its render calls it (C under no_grad; the
  training chunk's C and RaySOM with the gradient on, through `ray_som`;
  S alone through `som.som_em`), and the host's time until the call
  returns. The earlier checkout's package is copied under build/ with its
  imports renamed, so both run in this process on the same inputs, their
  calls interleaved earlier, this, this, earlier (the host's speed drifts
  between processes by more than the difference measured).

Prints one line per shape and writes all numbers to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
P, N_PROTOS = 64, 4
SHAPES = (("train chunk + RaySOM", 300, True, True), ("train chunk", 300, False, True),
          ("GT-depth render", 1024, False, False), ("sweep last chunk", 2850, False, False),
          ("serve chunk", 5000, False, False))
OTHER_WARPS = (1, 2, 8)
WRAPPER_RAYS = (300, 1024, 5000)
WRAPPER_RUNS = 100  # rounds of earlier, this, this, earlier


def build_kernels(csrc: Path, name: str, flags=()) -> ctypes.CDLL:
    """composite.cu and som.cu of `csrc` (with extra nvcc `flags`) in a
    library of their own under build/."""
    from scenerf_tpu_torch.ops import build

    out_dir = ROOT / "build" / f"kernels_compare_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out_dir / f"{stem}.o" for stem in ("composite", "som")]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, *flags, "-c", "-o", str(o),
                               str(csrc / f"{o.stem}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for o in objs]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc} ({name}):\n{out}")
    lib_path = out_dir / f"libcomposite_{name}.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib_path))


def set_signatures(lib: ctypes.CDLL, earlier: bool) -> ctypes.CDLL:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    som = [vp] * 2 + [i32] + [f32] * 3 + [vp] * 3  # means, stds, C, 3 scalars, 3 outputs
    lib.scenerf_sort_composite_f32.argtypes = ([vp] * 4 + [i32] * 2 + [vp] * 10
                                               + ([] if earlier else som) + [vp])
    lib.scenerf_ray_som_f32.argtypes = [vp] * 4 + [i32] * 3 + [f32] * 3 + [vp] * 4
    lib.scenerf_sort_composite_f32.restype = i32
    lib.scenerf_ray_som_f32.restype = i32
    return lib


def make_inputs(gen, R: int, dev):
    """A KITTI-shaped ray block: 32 uniform and 4 x 8 Gaussian distances
    (clamped at the near plane: ties), depths, densities with saturated
    alphas, colors, and the predicted Gaussians [R, 4] about which the
    Gaussian samples were drawn."""
    import torch

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import sampling as S

    cfg = C.kitti()
    sd_uni = S.uniform_sensor_distances(gen, R, cfg.n_pts_uni, cfg.min_sample_depth,
                                        cfg.max_sample_depth, device=dev)
    means = torch.sort(torch.rand(R, cfg.n_gaussians, generator=gen, device=dev) * 60.0,
                       dim=1).values
    stds = torch.rand(R, cfg.n_gaussians, generator=gen, device=dev) * 5.0 + 1.5
    sd_g = torch.clamp(torch.repeat_interleave(means, cfg.n_pts_per_gaussian, 1)
                       + torch.randn(R, cfg.n_pts_gauss, generator=gen, device=dev)
                       * torch.repeat_interleave(stds, cfg.n_pts_per_gaussian, 1),
                       min=cfg.min_clamp_depth)
    sd = torch.cat([sd_uni, sd_g], 1).contiguous()
    dv = sd * (0.8 + 0.2 * torch.rand(R, 1, generator=gen, device=dev))
    dens = torch.nn.functional.softplus(torch.randn(R, P, generator=gen, device=dev) - 1.0)
    hot = torch.rand(R, P, generator=gen, device=dev) < 0.2
    dens = torch.where(hot, dens * 100 + 50, dens)
    rgb = torch.rand(R, P, 3, generator=gen, device=dev)
    return [sd, dv, dens, rgb], means, stds, cfg


def call_ms(fn):
    """(CUDA events around one call of `fn` on an idle card, the host's time
    until the call returns), in ms."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def earlier_package(baseline: Path) -> str:
    """The earlier checkout's package copied under build/ as
    `scenerf_tpu_torch_earlier` (its imports renamed), so that one process
    can call both versions; returns the directory to put on sys.path."""
    import shutil

    dest = ROOT / "build" / "earlier_package"
    pkg = dest / "scenerf_tpu_torch_earlier"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(baseline / "scenerf_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in pkg.rglob("*.py"):
        f.write_text(re.sub(r"\bscenerf_tpu_torch\b", "scenerf_tpu_torch_earlier", f.read_text()))
    return str(dest)


def wrapper_ab(baseline: Path, dev) -> dict:
    """Each checkout's Python entries on the same inputs in one process, the
    calls interleaved earlier, this, this, earlier WRAPPER_RUNS times after
    two warm-ups each; per entry and checkout the medians of `call_ms`."""
    import importlib

    import torch

    sys.path.insert(0, earlier_package(baseline))
    mods = {who: (importlib.import_module(f"{pkg}.ops.composite"),
                  importlib.import_module(f"{pkg}.som"))
            for who, pkg in (("earlier", "scenerf_tpu_torch_earlier"),
                             ("this", "scenerf_tpu_torch"))}
    gen = torch.Generator(device=dev).manual_seed(1)
    entries = {}
    for R in WRAPPER_RAYS:
        ins, _, _, _ = make_inputs(gen, R, dev)

        def c_nograd(CM, SM, ins=ins):
            with torch.no_grad():
                CM.sort_composite(*ins)
        entries[f"C R={R} (no grad)"] = c_nograd
    ins, means, stds, cfg = make_inputs(gen, 300, dev)
    leaves = [ins[0], ins[1], *(t.clone().requires_grad_(True) for t in ins[2:])]
    g_means, g_stds = (t.clone().requires_grad_(True) for t in (means, stds))
    sigma, thr = cfg.som_sigma, cfg.som_mask_threshold

    def train_chunk(CM, SM):  # as each checkout's render_ray_block calls them
        if hasattr(CM, "SomInputs"):
            o = CM.sort_composite(*leaves, som=CM.SomInputs(g_means, g_stds, sigma, thr))
            em = [o.pop(k) for k in CM.SOM_KEYS]
            return SM.ray_som(g_means, g_stds, o["sensor_distance"], o["alphas"], sigma, thr,
                              em=em)
        o = CM.sort_composite(*leaves)
        return SM.ray_som(g_means, g_stds, o["sensor_distance"], o["alphas"], sigma, thr)

    with torch.no_grad():
        o = mods["this"][0].sort_composite(*ins)
    sd_s, alphas = o["sensor_distance"], o["alphas"]

    def s_alone(CM, SM):
        with torch.no_grad():
            SM.som_em(means, stds, sd_s, alphas, sigma, thr)

    entries["training chunk C + RaySOM R=300 (grad)"] = train_chunk
    entries["S alone R=300 (no grad)"] = s_alone
    rows = {}
    for key, fn in entries.items():
        calls = {who: (lambda m=m: fn(*m)) for who, m in mods.items()}
        for f in (*calls.values(), *calls.values()):
            f()
        torch.cuda.synchronize()
        times = {"earlier": [], "this": []}
        for _ in range(WRAPPER_RUNS):
            for who in ("earlier", "this", "this", "earlier"):
                times[who].append(call_ms(calls[who]))
        row = {}
        for who, ts in times.items():
            row[f"{who}_events_ms"] = statistics.median(t[0] for t in ts)
            row[f"{who}_host_ms"] = statistics.median(t[1] for t in ts)
            row[f"{who}_events_ms_quartiles"] = statistics.quantiles([t[0] for t in ts], n=4)
        rows[key] = row
        print(f"[wrapper] {key}: events around one call earlier "
              f"{row['earlier_events_ms'] * 1e3:.1f} us, this {row['this_events_ms'] * 1e3:.1f} us"
              f" (quartiles {[round(q * 1e3, 1) for q in row['earlier_events_ms_quartiles']]} / "
              f"{[round(q * 1e3, 1) for q in row['this_events_ms_quartiles']]} us); host until "
              f"return earlier {row['earlier_host_ms'] * 1e3:.1f} us, this "
              f"{row['this_host_ms'] * 1e3:.1f} us", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, help="root of the earlier checkout")
    ap.add_argument("--out", default="build/composite_compare.json")
    ap.add_argument("--reps", type=int, default=50, help="launches per CUDA graph")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.som import em_launch_args

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    baseline = Path(args.baseline).resolve()
    new = build.library()
    old = set_signatures(build_kernels(baseline / "scenerf_tpu_torch/ops/csrc", "earlier"), True)
    other = {w: set_signatures(build_kernels(build.CSRC, f"warps{w}",
                                             [f"-DSCENERF_WARPS_PER_BLOCK={w}"]), False)
             for w in OTHER_WARPS}
    stream = lambda: build.stream_handle(dev)  # noqa: E731  (the capture stream in a graph)
    gen = torch.Generator(device=dev).manual_seed(0)

    def graph_ms(fn) -> float:
        return cs.graph_ms(fn, reps=args.reps)

    def outputs(R, with_order):
        f32 = dict(dtype=torch.float32, device=dev)
        outs = [torch.empty(R, P, **f32) for _ in range(4)]
        outs += [torch.empty(R, **f32), torch.empty(R, 3, **f32), torch.empty(R, **f32),
                 torch.empty(R, **f32), torch.empty(R, dtype=torch.int32, device=dev)]
        outs.append(torch.empty(R, P, dtype=torch.int32, device=dev) if with_order else None)
        return outs

    def check(status, what):
        if status:
            raise RuntimeError(f"{what} launch failed: {status}")

    def old_c(ins, outs):
        check(old.scenerf_sort_composite_f32(*(t.data_ptr() for t in ins), ins[0].shape[0], P,
                                             *(build.ptr(t) for t in outs), stream()), "old C")

    def old_s(means, stds, sd_sorted, alphas, em, som_scalars):
        R, C = means.shape
        check(old.scenerf_ray_som_f32(*(t.data_ptr() for t in (means, stds, sd_sorted, alphas)),
                                      R, C, P, *som_scalars, *(t.data_ptr() for t in em),
                                      stream()), "old S")

    def new_c(ins, outs, som=None, lib=new):
        som_args = (None, None, 0, 0.0, 0.0, 0.0, None, None, None) if som is None else som
        check(lib.scenerf_sort_composite_f32(*(t.data_ptr() for t in ins), ins[0].shape[0], P,
                                             *(build.ptr(t) for t in outs), *som_args,
                                             stream()), "C")

    def new_s(means, stds, sd_sorted, alphas, em, som_scalars, lib=new):
        R, C = means.shape
        check(lib.scenerf_ray_som_f32(*(t.data_ptr() for t in (means, stds, sd_sorted, alphas)),
                                      R, C, P, *som_scalars, *(t.data_ptr() for t in em),
                                      stream()), "S")

    def pair(old_fn, new_fn):
        o1, n1, n2, o2 = graph_ms(old_fn), graph_ms(new_fn), graph_ms(new_fn), graph_ms(old_fn)
        return (o1 + o2) / 2, (n1 + n2) / 2, [o1, n1, n2, o2]

    def us_by_warps(d):
        return {w: round(v * 1e3, 3) for w, v in d.items()}

    rows = []
    for name, R, with_som, with_order in SHAPES:
        ins, means, stds, cfg = make_inputs(gen, R, dev)
        o_out, n_out = outputs(R, with_order), outputs(R, with_order)
        old_c(ins, o_out)
        (m_c, s_c), scalars, em_new = em_launch_args(means, stds, P, cfg.som_sigma,
                                                     cfg.som_mask_threshold)
        som_scalars = scalars[1:]
        som_args = (m_c.data_ptr(), s_c.data_ptr(), *scalars,
                    *(t.data_ptr() for t in em_new)) if with_som else None
        new_c(ins, n_out, som_args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(o_out, n_out)):
            if a is not None and not torch.equal(a, b):
                raise SystemExit(f"C at {name}: output {i} differs from the earlier C's")
        row = dict(shape=name, rays=R, samples=P, with_som=with_som, with_order=with_order)
        # bytes: the inputs read once, the outputs written once (C: 6 P + 4 P
        # (+ P order) + 7 per ray; S: 2 C + 2 P in, 3 C out)
        c_bytes = cs.nbytes(*ins, *(t for t in n_out if t is not None))
        s_bytes = cs.nbytes(m_c, s_c, n_out[0], n_out[2], *em_new)
        if with_som:
            em_old = [torch.empty_like(t) for t in em_new]
            old_s(m_c, s_c, o_out[0], o_out[2], em_old, som_scalars)
            torch.cuda.synchronize()
            for a, b in zip(em_old, em_new):
                if not torch.equal(a, b):
                    raise SystemExit(f"the EM inside C at {name} differs from the earlier S "
                                     f"(max abs {float((a - b).abs().max())})")

            def old_fn():
                old_c(ins, o_out)
                old_s(m_c, s_c, o_out[0], o_out[2], em_old, som_scalars)

            o, t, runs = pair(old_fn, lambda: new_c(ins, n_out, som_args))
            row.update(earlier_c_plus_s_ms=o, fused_ms=t, runs=runs,
                       earlier_c_ms=graph_ms(lambda: old_c(ins, o_out)),
                       earlier_s_ms=graph_ms(lambda: old_s(m_c, s_c, o_out[0], o_out[2], em_old,
                                                           som_scalars)),
                       this_s_ms=graph_ms(lambda: new_s(m_c, s_c, n_out[0], n_out[2], em_new,
                                                        som_scalars)),
                       fused_ms_other_warps={w: graph_ms(
                           lambda lib=lib: new_c(ins, n_out, som_args, lib))
                           for w, lib in other.items()},
                       s_ms_other_warps={w: graph_ms(
                           lambda lib=lib: new_s(m_c, s_c, n_out[0], n_out[2], em_new,
                                                 som_scalars, lib)) for w, lib in other.items()},
                       **cs.bound(c_bytes + s_bytes - cs.nbytes(n_out[0], n_out[2]),
                                  (41 + 2 * N_PROTOS ** 2 + 12 * N_PROTOS) * R * P))
        else:
            o, t, runs = pair(lambda: old_c(ins, o_out), lambda: new_c(ins, n_out))
            row.update(earlier_ms=o, this_ms=t, runs=runs,
                       ms_other_warps={w: graph_ms(lambda lib=lib: new_c(ins, n_out, lib=lib))
                                       for w, lib in other.items()},
                       **cs.bound(c_bytes, 41 * R * P))
        row["empty_kernel_ms"] = graph_ms(
            lambda: check(new.scenerf_empty_launch(R, stream()), "empty"))
        rows.append(row)
        if with_som:
            print(f"[C+S] {name} R={R}: earlier C + S {row['earlier_c_plus_s_ms'] * 1e3:.3f} us "
                  f"(C {row['earlier_c_ms'] * 1e3:.3f}, S {row['earlier_s_ms'] * 1e3:.3f}), this "
                  f"fused {row['fused_ms'] * 1e3:.3f} us, S alone {row['this_s_ms'] * 1e3:.3f} us; "
                  f"at 1 / 2 / 8 warps per block: fused "
                  f"{us_by_warps(row['fused_ms_other_warps'])}, S alone "
                  f"{us_by_warps(row['s_ms_other_warps'])}; bound {row['bound_ms'] * 1e3:.3f} us;"
                  f" empty kernel {row['empty_kernel_ms'] * 1e3:.3f} us", flush=True)
        else:
            print(f"[C] {name} R={R}: earlier {row['earlier_ms'] * 1e3:.3f} us, this "
                  f"{row['this_ms'] * 1e3:.3f} us; at 1 / 2 / 8 warps per block "
                  f"{us_by_warps(row['ms_other_warps'])}; bound {row['bound_ms'] * 1e3:.3f} us; "
                  f"empty kernel {row['empty_kernel_ms'] * 1e3:.3f} us", flush=True)
    wrapper_rows = wrapper_ab(baseline, dev)
    print(f"card: {card}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "reps": args.reps, "rows": rows,
                                          "wrappers": wrapper_rows}, indent=1))


if __name__ == "__main__":
    main()
