"""Kernel K5 (batch norm + activation, N1-N4) of this checkout beside an
earlier checkout's, at every batch norm configuration of the KITTI B7
spherical U-Net, f32 and bf16, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/baseline
    python3 scripts/norm_compare_torch.py --baseline build/baseline \
        [--out build/norm_compare.json]

The configurations are recorded as chip_smoke.py's phases 4 and 10 record
them: hooks on every FusedBatchNorm of SceneRF(kitti()) (seeded random
weights) during an eval encode and a train-mode encode of one synthetic
frame: shape, activation, residual, eps, momentum and layout, with the
number of sites of each on the training step and the eval encode.

The earlier checkout's `ops/csrc/norm.cu` is built into a library of its own
and called through ctypes with its interface (`scenerf_bn_{forward,
backward}_{f32,bf16}(..., work, work_cap, ...)`, a [528, 2C] f32 workspace);
this checkout's kernels are called through `ops.norm.launch_forward` and
`launch_backward`, as its autograd Function calls them. At each
configuration and element type, for each checkout:
- checks: the training forward (stages 3) against the plain version: the
  statistics and the running statistics at rtol 1e-5 (atol 1e-6 of the
  largest), y against the plain apply on the launch's own statistics (f32
  rtol 1e-5, bf16 within one bf16 spacing); the backward (stages 3, on the
  plain statistics) against the plain reduce (relative L2 <= 1e-4 per row)
  and dx (and d_residual) against the plain apply on the launch's own
  gradients (relative L2 <= 1e-4 in f32, 4e-3 in bf16);
- times alone (one launch's device time: CUDA-graph replay of --reps calls,
  no host, inputs L2-resident where they fit) of the training forward, the
  backward and the eval forward, in the order earlier, this, this, earlier;
  at each channel-last site also this checkout's streaming kernels, as a
  stage-1 launch then a stage-2 launch, where the plan takes the cluster
  path.
Bounds: bytes at 3.35 TB/s, counted as phase 12 counts them (forward 3
passes: x read for the statistics, read and written for y; backward 5: x and
dy read twice, dx written; plus the residual and d_residual where the
activation needs them) and the on-chip design's least (forward 2 passes,
backward 3). Sums per training step (192 sites) and per eval encode.

Prints one line per configuration, the per-step sums, a ranking of the
training configurations by sites x (earlier alone - bound) and writes all
numbers to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
REL_L2 = 1e-4
BF16_DX_REL_L2 = 4e-3
OLD_RED_BLOCKS = 528  # the earlier norm.cu's kRedBlocks: its workspace is [528, 2C] f32


def build_earlier(csrc: Path) -> ctypes.CDLL:
    """The earlier checkout's norm.cu in a library of its own under build/."""
    from scenerf_tpu_torch.ops import build

    out_dir = ROOT / "build" / "kernels_compare_norm_earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    obj, lib_path = out_dir / "norm.o", out_dir / "libnorm_earlier.so"
    nvcc = build._nvcc()
    res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / "norm.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / 'norm.cu'}:\n{res.stdout}{res.stderr}")
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fwd = [vp, vp, vp, i64, i32, i64] + [vp] * 6 + [i64, f32, f32, f32, i32, i32, i32, vp]
    bwd = [vp] * 5 + [i64, i32, i64] + [vp] * 4 + [i64, f32, i32, i32, i32, vp]
    for dt in ("f32", "bf16"):
        for name, argtypes in ((f"scenerf_bn_forward_{dt}", fwd),
                               (f"scenerf_bn_backward_{dt}", bwd)):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
    return lib


def record_sites(dev) -> dict:
    """{"eval": [...], "train": [...]}: (shape, act, residual, eps, momentum,
    plane) of every batch norm site of an eval encode and a train-mode
    encode of SceneRF(kitti()), as chip_smoke.py's phases 4 and 10 see
    them."""
    import torch

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.model import SceneRF, compute_sphere_maps
    from scenerf_tpu_torch.ops import norm as NM

    cfg = C.kitti()
    K = default_intrinsics(cfg)
    maps = compute_sphere_maps(cfg, K)
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg)
    # the serve path's frame (phase 4) and the training batch's (phase 10,
    # through Trainer.device_batch): their strides differ, and so do the
    # layouts cuDNN gives the encoder's convolutions
    imgs = {"eval": torch.from_numpy(input_frame(cfg, seed=0)).to(dev),
            "train": torch.as_tensor(make_batch(cfg, seed=0)["img_input"],
                                     dtype=torch.float32, device=dev)}
    sites = {"eval": [], "train": []}
    for path in sites:
        def record(mod, args, kwargs, path=path):
            x = args[0]
            r = args[1] if len(args) > 1 else kwargs.get("residual")
            sites[path].append((tuple(x.shape), mod.act, r is not None, mod.eps, mod.momentum,
                                NM.plane(x)))

        hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
                 for m in model.modules() if isinstance(m, FusedBatchNorm)]
        model.train(path == "train")
        lv = model.encode(imgs[path], K, sphere_maps=maps)
        del lv
        for h in hooks:
            h.remove()
    del model
    torch.cuda.empty_cache()
    return sites


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, help="root of the earlier checkout")
    ap.add_argument("--out", default="build/norm_compare.json")
    ap.add_argument("--reps", type=int, default=30, help="launches per CUDA graph")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import norm as NM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    old = build_earlier(Path(args.baseline).resolve() / "scenerf_tpu_torch/ops/csrc")
    build.library()
    sites = record_sites(dev)
    count = {path: {} for path in sites}
    for path, keys in sites.items():
        for k in keys:
            count[path][k] = count[path].get(k, 0) + 1
    configs = sorted(set(count["train"]) | set(count["eval"]),
                     key=lambda k: (-math.prod(k[0]), k[1], k[2], k[5]))
    layouts = {p: sum(bool(k[-1]) for k in keys) for p, keys in sites.items()}
    print(f"card: {card} | {len(configs)} configurations; sites {len(sites['train'])} train "
          f"({layouts['train']} channel-first), {len(sites['eval'])} eval ({layouts['eval']} "
          f"channel-first)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: build.stream_handle(dev)  # noqa: E731  (the capture stream in a graph)

    def fail(msg):
        raise SystemExit(f"FAILED: {msg}")

    def close(what, a, b):
        atol = 1e-6 * float(b.abs().max())
        bad = int(((a - b).abs() > RTOL * b.abs() + atol).sum())
        if bad:
            fail(f"{what}: {bad} values beyond rtol {RTOL}")

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm()) / max(float(b.float().norm()), 1e-30)

    def graph_ms(fn):
        return cs.graph_ms(fn, reps=args.reps)

    rows = []
    for dt_name in args.dtypes.split(","):
        dtype = getattr(torch, dt_name)
        for key in configs:
            shape, act, has_res, eps, mom, layout = key
            Cn = shape[-1]
            Mn = math.prod(shape[:-1])

            def draw():
                if not layout:
                    return torch.randn(shape, generator=gen, device=dev).to(dtype)
                return torch.randn(shape[0], Cn, *shape[1:-1], generator=gen,
                                   device=dev).to(dtype).movedim(1, -1)

            x = (draw().float() * 2 + 0.5).to(dtype)
            x[..., 0] = 0.5  # a constant channel: mean2 - mean^2 ties at 0
            w = torch.rand(Cn, generator=gen, device=dev) + 0.5
            b = torch.rand(Cn, generator=gen, device=dev) - 0.5
            rm = torch.rand(Cn, generator=gen, device=dev) * 0.4 - 0.2
            rv = torch.rand(Cn, generator=gen, device=dev) + 0.5
            r = draw() if has_res else None
            dy = draw()
            need_r = act != "identity"
            y, dx = torch.empty_like(x), torch.empty_like(x)
            d_r = torch.empty_like(x) if has_res and need_r else None
            st_p = NM.stats_plain(x, w, b, rm.clone(), rv.clone(), mom, eps)
            gr_p = NM.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)
            st, gr = torch.empty_like(st_p), torch.empty_like(gr_p)
            run = [rm.clone(), rv.clone()]
            work = torch.empty(2 * OLD_RED_BLOCKS * Cn, dtype=torch.float32, device=dev)
            dts = NM.DTYPES[dtype]
            what = f"{dts} {list(shape)} {act}{' + residual' if has_res else ''}" \
                   f"{' channel-first' if layout else ''}"

            def old_fwd(training=True):
                s = getattr(old, f"scenerf_bn_forward_{dts}")(
                    x.data_ptr(), build.ptr(r), y.data_ptr(), Mn, Cn, layout, w.data_ptr(),
                    b.data_ptr(), run[0].data_ptr(), run[1].data_ptr(), st.data_ptr(),
                    work.data_ptr(), work.numel(), mom, 1.0 - mom, eps, NM.ACTS.index(act),
                    int(training), 3, stream())
                if s:
                    fail(f"earlier forward {what}: CUDA error {s}")

            def old_bwd():
                s = getattr(old, f"scenerf_bn_backward_{dts}")(
                    x.data_ptr(), build.ptr(r), dy.data_ptr(), dx.data_ptr(), build.ptr(d_r),
                    Mn, Cn, layout, w.data_ptr(), st_p.data_ptr(), gr.data_ptr(),
                    work.data_ptr(), work.numel(), eps, NM.ACTS.index(act), 1, 3, stream())
                if s:
                    fail(f"earlier backward {what}: CUDA error {s}")

            def new_fwd(training=True, stages=3):
                NM.launch_forward(x, w, b, *run, training, mom, eps, act, r, y=y, stats=st,
                                  stages=stages)

            def new_bwd(stages=3):
                NM.launch_backward(x, dy, w, st_p, True, eps, act, r, residual_grad=has_res,
                                   stages=stages, grads=gr, dx=dx, d_res=d_r)

            for side, fwd, bwd in (("earlier", old_fwd, old_bwd), ("this", new_fwd, new_bwd)):
                run[0].copy_(rm)
                run[1].copy_(rv)
                fwd()
                for i in range(5):
                    close(f"{side} {what} statistics row {i}", st[i], st_p[i])
                rp = [rm.clone(), rv.clone()]
                NM.stats_plain(x, w, b, *rp, mom, eps)
                close(f"{side} {what} running mean", run[0], rp[0])
                close(f"{side} {what} running var", run[1], rp[1])
                y_p = NM.apply_plain(x, st, act, r)
                if dtype == torch.float32:
                    close(f"{side} {what} y", y, y_p)
                else:
                    spac = (y.float() - y_p.float()).abs() / torch.exp2(
                        torch.floor(torch.log2(y_p.float().abs().clamp(min=1e-30))) - 7)
                    if float(spac.max()) > 1.0:
                        fail(f"{side} {what} y: {float(spac.max()):.2f} bf16 spacings")
                bwd()
                for i in range(4):
                    if rel_l2(gr[i], gr_p[i]) > REL_L2:
                        fail(f"{side} {what} gradients row {i}: relative L2 "
                             f"{rel_l2(gr[i], gr_p[i]):.2e}")
                dx_p, dr_p = NM.bwd_apply_plain(x, dy, st_p, gr, act, r)
                lim = REL_L2 if dtype == torch.float32 else BF16_DX_REL_L2
                for name, a_, b_ in (("dx", dx, dx_p), ("d_r", d_r, dr_p)):
                    if a_ is not None and rel_l2(a_, b_) > lim:
                        fail(f"{side} {what} {name}: relative L2 {rel_l2(a_, b_):.2e}")
            t = {}
            for name, o_fn, n_fn in (("fwd", old_fwd, new_fwd), ("bwd", old_bwd, new_bwd),
                                     ("eval", lambda: old_fwd(False), lambda: new_fwd(False))):
                o1, n1, n2, o2 = graph_ms(o_fn), graph_ms(n_fn), graph_ms(n_fn), graph_ms(o_fn)
                t[name] = {"earlier": (o1 + o2) / 2, "this": (n1 + n2) / 2}
            # where the plan takes the cluster path, this checkout's streaming
            # kernels at the site: stage 1, then stage 2
            plan = {}
            for d, fn in (("forward", new_fwd), ("backward", new_bwd)):
                vector = not layout and Cn % (16 // x.element_size()) == 0
                plan[d] = NM.plan(Mn, Cn, x.element_size(), vector, d, act, has_res,
                                  bool(layout))._asdict()
                if plan[d]["path"] == "cluster":
                    k = "fwd" if d == "forward" else "bwd"
                    t[k]["streaming"] = graph_ms(lambda fn=fn: (fn(stages=1), fn(stages=2)))
            nb = lambda *ts: sum(u.numel() * u.element_size() for u in ts if u is not None)  # noqa: E731
            r_act = r if need_r else None
            to_ms = 1e3 / cs.HBM_BYTES_PER_S
            bounds = {"fwd": nb(x, x, r, y) * to_ms, "fwd_min": nb(x, r, y) * to_ms,
                      "bwd": nb(x, dy, r_act, x, dy, r_act, dx, d_r) * to_ms,
                      "bwd_min": nb(x, dy, r_act, dx, d_r) * to_ms,
                      "eval": nb(x, r, y) * to_ms}
            row = dict(dtype=dts, shape=list(shape), act=act, residual=has_res,
                       channel_first=bool(layout),
                       sites={p: count[p].get(key, 0) for p in count}, ms=t, bound_ms=bounds,
                       plan=plan)
            rows.append(row)
            print(f"[{what}] x{row['sites']['train']} train x{row['sites']['eval']} eval | "
                  f"fwd {t['fwd']['earlier'] * 1e3:.2f} -> {t['fwd']['this'] * 1e3:.2f} us "
                  f"(bound {bounds['fwd'] * 1e3:.2f}, min {bounds['fwd_min'] * 1e3:.2f}) | "
                  f"bwd {t['bwd']['earlier'] * 1e3:.2f} -> {t['bwd']['this'] * 1e3:.2f} us "
                  f"(bound {bounds['bwd'] * 1e3:.2f}, min {bounds['bwd_min'] * 1e3:.2f}) | "
                  f"eval {t['eval']['earlier'] * 1e3:.2f} -> {t['eval']['this'] * 1e3:.2f} us"
                  f" | other paths fwd { {k: round(v * 1e3, 2) for k, v in t['fwd'].items()} } "
                  f"bwd { {k: round(v * 1e3, 2) for k, v in t['bwd'].items()} } | plan "
                  f"{ {d: (p_['path'], p_['cluster'], p_['slices'], p_['smem']) for d, p_ in plan.items()} }",
                  flush=True)
            del x, r, dy, y, dx, d_r, work
            torch.cuda.empty_cache()

    summary = {}
    for dts in sorted({row["dtype"] for row in rows}):
        mine = [row for row in rows if row["dtype"] == dts]

        def step(get, path="train"):
            return sum(row["sites"][path] * get(row) for row in mine)

        s = {f"{d}_{side}_ms": step(lambda r_: r_["ms"][d][side], "eval" if d == "eval" else
                                    "train")
             for d in ("fwd", "bwd", "eval") for side in ("earlier", "this")}
        s.update({f"{k}_bound_ms": step(lambda r_: r_["bound_ms"][k],
                                        "eval" if k == "eval" else "train")
                  for k in ("fwd", "fwd_min", "bwd", "bwd_min", "eval")})
        summary[dts] = s
        print(f"[{dts} per step] train forward {s['fwd_earlier_ms']:.3f} -> {s['fwd_this_ms']:.3f}"
              f" ms (bound {s['fwd_bound_ms']:.3f}, on-chip min {s['fwd_min_bound_ms']:.3f}); "
              f"backward {s['bwd_earlier_ms']:.3f} -> {s['bwd_this_ms']:.3f} ms (bound "
              f"{s['bwd_bound_ms']:.3f}, min {s['bwd_min_bound_ms']:.3f}); eval encode "
              f"{s['eval_earlier_ms']:.3f} -> {s['eval_this_ms']:.3f} ms (bound "
              f"{s['eval_bound_ms']:.3f})", flush=True)
        gap = sorted(((row["sites"]["train"] * (row["ms"][d]["earlier"] - row["bound_ms"][d]), d,
                       row["shape"], row["act"], row["residual"])
                      for row in mine if row["sites"]["train"] for d in ("fwd", "bwd")),
                     reverse=True)
        print(f"[{dts} ranking] sites x (earlier alone - bound), ms: "
              + "; ".join(f"{g:.3f} {d} {shp} {a}{'+r' if res else ''}"
                          for g, d, shp, a, res in gap[:20]), flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows, "per_step": summary}, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
