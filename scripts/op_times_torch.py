"""Device time, calls and bound of the ops of the port's KITTI training step
that are library calls, K3 (the ResnetFC field MLPs, cuBLAS) and K6 (the
decoder's 3x3 convs, dilated 1/2/3 in the residual blocks, cuDNN), and of
K5 (FusedBatchNorm with its activation and residual: kernels N1-N4).

    python3 scripts/op_times_torch.py [--out op_times.json] [--dtype bfloat16]

One warm-up step, then one step of Trainer(kitti(compute_dtype=--dtype))
(random weights, make_batch, TF32 off; float32 by default, or the bf16
compute path) with CUDA events recorded around every forward and backward
call of those modules (module hooks). Per op and direction it prints the
calls per step, the summed event time, and the bound: the sum over the calls
of max(bytes / 3.35 TB/s, operations / peak), the bytes counting each input
read once and each output written once (activations and weights in the
compute dtype, 4 or 2 bytes; the weight gradients in the backward), the
operations 2 per multiply-add for K3 and K6 over 67 TFLOP/s f32 (989
TFLOP/s dense bf16 on the tensor cores in bf16) and ~7 (forward) / ~10
(backward) per element for K5 over the f32 rate (its arithmetic is f32 in
both; its bytes those of the fused kernels: 3 passes forward, 5 backward,
plus the residual). For K3 and K6 the op's plain version is the library call
itself, so its plain and library times are this time. The event pairs add a few microseconds per call.
Needs one CUDA device; no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM dense bf16 on the tensor cores
F32 = 4


def bound_ms(n_bytes: float, n_ops: float, flops: float = F32_FLOPS) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / flops) * 1e3


def linear_work(mlp, n: int, backward: bool, E: int = F32):
    """(bytes, ops) of a ResnetFC call on n points: its Linear layers' GEMMs
    (lin_z counted once as the concatenated product it runs as); reads the
    inputs z, x and the weights, writes the output (backward: reads the
    output cotangent, z, x and the weights, writes dz, dx and the weight
    gradients), E bytes an element."""
    lins = [mlp.lin_in, *mlp.lin_z, *(b.fc_0 for b in mlp.blocks),
            *(b.fc_1 for b in mlp.blocks), mlp.lin_out]
    macs = sum(n * l.in_features * l.out_features for l in lins)
    weights = sum(l.weight.numel() + l.bias.numel() for l in lins)
    io = n * (mlp.lin_z[0].in_features + mlp.lin_in.in_features + mlp.lin_out.out_features)
    if backward:  # dgrad + wgrad: twice the forward's products
        return E * (io + n * (mlp.lin_z[0].in_features + mlp.lin_in.in_features)
                    + 2 * weights), 4 * macs
    return E * (io + weights), 2 * macs


def conv_work(conv, x_shape, y_shape, backward: bool, E: int = F32):
    """(bytes, ops) of a channel-last conv [B, H, W, Cin] -> [B, H', W', Cout],
    E bytes an element."""
    n_in, n_out = x_shape.numel(), y_shape.numel()
    k = conv.weight.numel() // conv.out_channels  # Cin * kh * kw
    macs = n_out * k
    w = conv.weight.numel() + (conv.bias.numel() if conv.bias is not None else 0)
    if backward:  # reads dy, x, weights; writes dx, dweights
        return E * (n_out + n_in + 2 * w + n_in), 4 * macs
    return E * (n_in + n_out + w), 2 * macs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table as JSON here")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the config's compute_dtype")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.encoder.backbones import Conv2dCL
    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = C.kitti(compute_dtype=args.dtype)
    E = 2 if args.dtype == "bfloat16" else F32  # bytes of an activation element
    mm_flops = BF16_FLOPS if args.dtype == "bfloat16" else F32_FLOPS
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg)
    trainer = Trainer(cfg, device=dev, model=model)
    batch = make_batch(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer.train_step(batch, noise=model.draw_noise(1, cfg.n_sources, gen, dev))  # warm-up

    groups = {"K3": [model.mlp, model.mlp_gaussian],
              "K5": [m for m in model.modules() if isinstance(m, FusedBatchNorm)],
              "K6": [m for m in model.net_rgb.decoder.modules()
                     if isinstance(m, Conv2dCL) and m.kernel_size == (3, 3)]}
    records = []  # (op, direction, start event, end event, bytes, ops)
    pending = {}

    def res_of(inp) -> bool:
        return len(inp) > 1 and inp[1] is not None

    def hooks(op, mod):
        def fwd_pre(m, inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending[(id(m), "fwd")] = ev

        def fwd_post(m, inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if op == "K3":
                b, o = linear_work(m, inp[0].shape[0], False, E)
            elif op == "K5":
                # the fused kernels' least traffic: x read twice, y written, r read
                b, o = E * (3 + res_of(inp)) * inp[0].numel(), 7 * inp[0].numel()
            else:
                b, o = conv_work(m, inp[0].shape, out.shape, False, E)
            records.append((op, "fwd", pending.pop((id(m), "fwd")), ev, b, o))
            if torch.is_grad_enabled():  # the backward pops them, last call first
                shapes[id(m)].append((inp[0].shape, out.shape, res_of(inp)))

        def bwd_pre(m, grad_out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending[(id(m), "bwd")] = ev

        def bwd_post(m, grad_in, grad_out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            x_shape, y_shape, res = shapes[id(m)].pop()
            if op == "K3":
                b, o = linear_work(m, x_shape[0], True, E)
            elif op == "K5":
                # x and dy read twice, dx written; r read and d_r written where the
                # activation needs z
                b = E * (5 + 2 * (res and m.act != "identity")) * x_shape.numel()
                o = 10 * x_shape.numel()
            else:
                b, o = conv_work(m, x_shape, y_shape, True, E)
            records.append((op, "bwd", pending.pop((id(m), "bwd")), ev, b, o))

        return [mod.register_forward_pre_hook(fwd_pre), mod.register_forward_hook(fwd_post),
                mod.register_full_backward_pre_hook(bwd_pre),
                mod.register_full_backward_hook(bwd_post)]

    shapes = defaultdict(list)
    handles = [h for op, mods in groups.items() for m in mods for h in hooks(op, m)]
    torch.cuda.synchronize()
    trainer.train_step(batch, noise=model.draw_noise(1, cfg.n_sources, gen, dev))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()

    table = defaultdict(lambda: dict(calls=0, ms=0.0, bound_ms=0.0, bytes=0.0, ops=0.0))
    for op, direction, start, end, b, o in records:
        row = table[f"{op} {direction}"]
        row["calls"] += 1
        row["ms"] += start.elapsed_time(end)
        row["bound_ms"] += bound_ms(b, o, F32_FLOPS if op == "K5" else mm_flops)
        row["bytes"] += b
        row["ops"] += o
    print(f"card: {card}; one KITTI training step ({args.dtype}, TF32 off), module event "
          f"times")
    print("| op | calls/step | ms/step | bound ms/step | GB | GFLOP |")
    for key in sorted(table):
        r = table[key]
        print(f"| {key} | {r['calls']} | {r['ms']:.3f} | {r['bound_ms']:.3f} | "
              f"{r['bytes'] / 1e9:.3f} | {r['ops'] / 1e9:.1f} |")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "dtype": args.dtype,
                                              "ops": dict(table)}, indent=1))


if __name__ == "__main__":
    main()
