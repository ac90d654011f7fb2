#!/usr/bin/env python3
"""Read the two ends of a cell's limits on the card, at the cell's own size,
in one process: the program's compared numbers over many seeds (the lower
reading), the control's (the reference in the precision below the one the
configuration states, put in the program's place: fp8 products for bf16,
TF32 for f32) and the program with a fault planted.

    python3 benchmark/control.py --workload kitti-train-bf16 \
        --seeds 101,102,...,112 --control-seeds 101,102,103 \
        [--faults half_batch,witness_f32] [--seconds 4] [--out FILE.jsonl]

Each seed sets the program up, runs a window of `--seconds` at the cell's
own load (a sweep: so that the reference has as many poses to compare as a
run; training: so that the probe step comes from a trained state), and is
checked as a run is. Each reading is printed as one JSON line (and appended
to `--out`): {"seed", "side": "program" | "control" | fault, numbers...};
`witness_f32` is no fault but the program computing in f32 (for a bf16
configuration), a second witness beside the reference. A seed that raises
is printed with its error and the next one runs. The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import compare  # noqa: E402
from benchmark.harness import device as D  # noqa: E402

D.fix_caches(ROOT)

from benchmark.harness.cell import Cell, load_spec  # noqa: E402
from benchmark.harness.trace import Brackets  # noqa: E402


def emit(out, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(cell, seed: int, device, seconds: float, control: bool, fault=None) -> list:
    """[(side, numbers)] of one seed: the program's (or the faulty
    program's), and where asked the control's on the same inputs."""
    import torch

    drv = cell.driver().Driver(cell, seed, device, fault=fault)
    t = time.perf_counter()
    drv.setup()
    drv.window(seconds, Brackets())
    drv.release()
    side, lower = fault or "program", cell.conf["dtype"] if control else None
    out = []
    if drv.kind == "train":
        ref = drv.reference()
        sides = drv.probe_sides(lower)
        nums = compare.train_numbers(drv.first, ref)
        nums.update(compare.probe_numbers(drv.program_probe(), sides["ref"], sides.get("f32")))
        nums.update(compare.adamw_numbers(drv.adamw_norms()))
        out.append((side, nums))
        if control:
            low = compare.train_numbers(drv.reference(lower=lower), ref)
            low.update(compare.probe_numbers(sides["control"], sides["ref"], sides.get("f32")))
            out.append(("control", low))
    else:
        picks = drv.sample()
        out.append((side, compare.sweep_numbers(drv.pairs(picks))))
        if control:
            out.append(("control", compare.sweep_numbers(drv.pairs(picks, lower))))
    del drv
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    print(f"seed {seed} {side}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return out


def emit_all(out, cell, seed, args, control, fault=None) -> None:
    try:
        for side, nums in readings(cell, seed, args.device, args.seconds, control, fault):
            emit(out, {"cell": cell.name, "seed": seed, "side": side, **nums})
    except Exception as e:  # one seed's error does not end the readings
        emit(out, {"cell": cell.name, "seed": seed, "side": fault or "program",
                   "error": repr(e)})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = Cell(load_spec(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        emit_all(args.out, cell, seed, args, seed in ctrl)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in sorted(ctrl) or seeds[:3]:
            emit_all(args.out, cell, seed, args, False, fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
