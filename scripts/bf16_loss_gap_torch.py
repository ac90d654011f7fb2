"""The gap between the bf16 and the f32 training step's loss, step 0 from the
same weights and draws at the flagship shapes (chip_smoke.py's phase 13
prints it), over several seeds, on one NVIDIA GPU.

    python3 scripts/bf16_loss_gap_torch.py [--seeds 0,1,2,3,4] \
        [--modes kernels,plain,stats_bf16,unbiased_var] [--tree DIR] \
        [--out build/bf16_loss_gap.json]

`--tree` imports the port from another checkout (a `git archive` of an
earlier commit): the gap with that checkout's kernels. For each seed:
weights from `torch.manual_seed(seed)`, `make_batch(cfg, seed)` and the
noise of a generator seeded with `seed`; both steps start from the same
weights and running statistics. Modes:
- `kernels`: both steps on the kernels;
- `plain`: both on every kernel's plain version (another summation order
  everywhere, K5's statistics included);
- two faulty controls, both steps on the plain versions and the bf16 step's
  batch norm altered: `stats_bf16` rounds the batch mean and variance to
  bf16 (statistics kept in the compute dtype), `unbiased_var` takes the
  variance over M - 1 (torch's default for `var`).
Prints the relative gap |loss16 - loss32| / |loss32| of every seed and mode
and, per mode, the largest and the mean over the seeds; and the bf16 step's
batch-statistics error (`chip_smoke.bn_stats_error`: the statistics each
batch norm of the step used, recovered from its running statistics set to
0 before the step, against the f64 statistics of the site's bf16 input, in
units of the channel's mean square), the check that replaced the loss gap
in phase 13.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("kernels", "plain", "stats_bf16", "unbiased_var")


def faulty_plain(NM, fault: str):
    """`batch_norm_act_plain` with `fault` in its bf16 training statistics."""
    import torch

    plain = NM.batch_norm_act_plain

    def bn(x, weight, bias, running_mean, running_var, training, momentum, eps, act="identity",
           residual=None):
        if not training or x.dtype != torch.bfloat16:
            return plain(x, weight, bias, running_mean, running_var, training, momentum, eps,
                         act, residual)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dims)
        var = torch.clamp(torch.square(xf).mean(dims) - torch.square(mean), min=0.0)
        if fault == "stats_bf16":
            mean, var = mean.bfloat16().float(), var.bfloat16().float()
        else:
            m = xf.numel() // xf.shape[-1]
            var = var * m / max(m - 1, 1)
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
        mul = weight * torch.rsqrt(var + eps)
        z = xf * mul + (bias - mean * mul)
        if residual is not None:
            z = z + residual.float()
        return NM.activation(z, act).to(x.dtype)

    return bn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--tree", default=str(ROOT), help="root of the checkout whose port runs")
    ap.add_argument("--out", default="build/bf16_loss_gap.json")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import norm as NM
    from scenerf_tpu_torch.train import Trainer

    sys.path.insert(0, str(ROOT))
    from chip_smoke import bn_stats_error, bn_stats_hooks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg16 = C.kitti(n_sources=4, ray_chunk=1200, n_gt_depth=256, compute_dtype="bfloat16")
    cfg32 = cfg16.replace(compute_dtype="float32")
    modes = args.modes.split(",")
    print(f"card: {card} | port from {Path(args.tree).resolve()} | modes {modes}", flush=True)
    gaps = {m: {} for m in modes}
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.manual_seed(seed)
        with torch.device(dev):
            model32 = SceneRF(cfg32)
            model16 = SceneRF(cfg16)
        state = {k: v.detach().clone() for k, v in model32.state_dict().items()}
        batch = make_batch(cfg16, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = model16.draw_noise(1, cfg16.n_sources, gen, dev)

        def loss(model, cfg, stats_error=None):
            """The step's loss; with `stats_error` (a list), the step's
            batch-statistics error appended to it."""
            model.load_state_dict(state)
            model.train()
            record = []
            hooks = bn_stats_hooks(model, record) if stats_error is not None else []
            metrics = Trainer(cfg, device=dev, model=model).train_step(batch, noise=noise)
            for h in hooks:
                h.remove()
            value = float(metrics["total_loss"])
            if value != value:
                raise SystemExit(f"seed {seed}: loss not finite")
            if stats_error is not None:
                stats_error.append(bn_stats_error(record))
            return value

        losses32 = {}
        for mode in modes:
            err = []
            on_kernels = mode == "kernels"
            kind = mode if on_kernels else "plain"
            with contextlib.nullcontext() if on_kernels else build.plain_versions():
                if kind not in losses32:
                    losses32[kind] = loss(model32, cfg32)
                if mode in ("stats_bf16", "unbiased_var"):
                    saved = NM.batch_norm_act_plain
                    NM.batch_norm_act_plain = faulty_plain(NM, mode)
                    try:
                        l16 = loss(model16, cfg16, err)
                    finally:
                        NM.batch_norm_act_plain = saved
                else:
                    l16 = loss(model16, cfg16, err)
            gap = abs(l16 - losses32[kind]) / abs(losses32[kind])
            gaps[mode][seed] = dict(loss32=losses32[kind], loss16=l16, rel_gap=gap,
                                    stats_error=err[0])
            print(f"seed {seed} {mode}: f32 {losses32[kind]:.6f} bf16 {l16:.6f} rel gap "
                  f"{gap:.4e}; bf16 batch-statistics error {err[0]:.4e}", flush=True)
        del model32, model16
        torch.cuda.empty_cache()
    summary = {}
    for mode, per_seed in gaps.items():
        g = [v["rel_gap"] for v in per_seed.values()]
        e = [v["stats_error"] for v in per_seed.values()]
        summary[mode] = dict(max=max(g), mean=statistics.mean(g), min=min(g),
                             stats_error_min=min(e), stats_error_max=max(e))
        print(f"[{mode}] rel gap over seeds {sorted(per_seed)}: min {min(g):.4e}, mean "
              f"{statistics.mean(g):.4e}, max {max(g):.4e}; batch-statistics error min "
              f"{min(e):.4e}, max {max(e):.4e}", flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "tree": str(Path(args.tree).resolve()),
                               "gaps": gaps, "summary": summary}, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
