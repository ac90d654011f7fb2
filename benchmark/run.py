#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload kitti-train-bf16 --seed 7 --seconds 45 --trace 0

Loads the cell named in BENCHMARK.json (its configuration, traffic mix and
limits, found by name), makes every input from the seed, sets the program
up and warms every shape up (all of that is `setup_s`), measures for
`--seconds`, then checks what the timed path produced against the plain
reference once the program's state is freed. With `--trace 1` it also
traces a few steps or poses after the window and reports the cell's
per-layer metrics instead of its end-to-end ones. The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, (breakdown), and the numbers compared beside their limits under
`checks`; the same numbers are the last lines of standard error. Needs as
many CUDA cards as the cell names; without them it exits with 3 and prints
no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import device as D  # noqa: E402

D.fix_caches(ROOT)

from benchmark.harness import compare  # noqa: E402
from benchmark.harness.cell import Cell, load_spec  # noqa: E402
from benchmark.harness.trace import Brackets  # noqa: E402

EXIT_NO_CARD, EXIT_JAX, EXIT_NO_LIMITS = 3, 4, 5


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def end_to_end(cell: Cell, res: dict, setup_s: float, peak_bytes: int) -> dict:
    values = dict(res["metrics"], setup_s=setup_s, peak_mem_gib=peak_bytes / 2 ** 30)
    out = {}
    for m in cell.end_to_end:
        # a metric `<quantity>.<variant>` (its own bound for some cells) is
        # the driver's `<quantity>`
        name = m["name"]
        while name not in values and "." in name:
            name = name.rsplit(".", 1)[0]
        if name not in values:
            raise KeyError(f"the {cell.traffic['driver']} driver gives no {m['name']}")
        out[m["name"]] = {"value": values[name], "unit": m["unit"]}
    return out


def per_layer(cell: Cell, rec) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
             fault=None):
    """Set up, measure, trace and check one run of `cell` on `device` ->
    the result line (a dict), or raise. `fault` (tests only) is the
    driver's planted fault."""
    import torch

    on_card = device.startswith("cuda")
    driver = cell.driver().Driver(cell, seed, device, fault=fault)
    driver.setup()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    brackets = Brackets()
    res = driver.window(seconds, brackets)
    record = D.record(cell.chips) if on_card else {"platform": "cpu", "count": 0,
                                                    "memory_peak_bytes": 0}
    log(f"window {res['seconds']:.3f} s, {res['units']} {driver.kind} units, "
        f"{res['failed']} failed")
    holder = {}
    if trace:
        driver.profile(ROOT / "build" / "bench_trace", holder)
    from scenerf_tpu_torch.ops import build

    log(f"launches of the program's kernels: {json.dumps(build.LAUNCHES)}")
    work = driver.work()
    driver.release()

    numbers = driver.check()
    for k, v in numbers.items():
        if k not in cell.limits:
            log(f"reading {k} = {v}")
    correct = res["failed"] == 0 and res["attempted"] > 0 and compare.verdict(
        numbers, cell.limits)

    rec = SimpleNamespace(cell=cell, kind=driver.kind, window=res, brackets=brackets,
                          trace=holder.get("trace"), profiled_units=holder.get("units", 0),
                          profiled_encodes=holder.get("encodes", 0), work=work)
    if trace:
        tr = rec.trace
        busy_us, _ = tr.busy()
        record.update(busy_s=busy_us / 1e6, window_s=tr.window_us / 1e6)
        log(f"trace: markers {tr.marker_names[0][:60]} / {tr.marker_names[1][:60]}, "
            f"alignment {tr.align_error_us:.1f} us, by kind {json.dumps(tr.by_kind())}")
        metrics = per_layer(cell, rec)
    else:
        metrics = end_to_end(cell, res, setup_s, record["memory_peak_bytes"])
    line = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": record}
    if trace:
        line["breakdown"] = {"device_ops": [list(x) for x in rec.trace.top_ops(10)],
                             "idle_gaps": [list(x) for x in rec.trace.idle_gaps()[:10]]}
    line["checks"] = {k: {"value": numbers.get(k), "limit": lim}
                      for k, lim in cell.limits.items()}
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    cell = Cell(load_spec(ROOT), args.workload)
    if not cell.limits:
        log(f"no limits for {cell.name} under benchmark/limits/")
        return EXIT_NO_LIMITS
    import torch

    if not D.has_cards(cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}")
        return EXIT_NO_CARD
    log(f"card: {D.power_limit()}")
    torch.cuda.set_device(0)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    found = D.loaded_forbidden()
    if found:
        log(f"modules of {', '.join(found)} are loaded in this process")
        return EXIT_JAX
    for k, c in line["checks"].items():
        log(f"check {k} = {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
