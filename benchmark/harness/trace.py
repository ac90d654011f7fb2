"""The device trace of a traced run and the host brackets beside it.

`Brackets` records, on the host clock, which call of the program the
benchmark was in (the train_step call, an encode, a pose's render, the copy
to the host). `profiled` traces a block of steps or poses with
`torch.profiler` recording CUDA activity only (no CPU ops, shapes or stacks)
and puts a marker kernel on the device just before and just after the
block, each launched right after a synchronize at a known host time: the
two markers place the host clock on the trace's clock and bound the traced
window. `Trace` holds the device's operations inside that window as
intervals, their union (busy time), the idle gaps labelled with the bracket
the host was in when each began, and the kernels' time by kind (the KINDS
table of the program's `scripts/profile_serve_torch.py`, copied).
"""
from __future__ import annotations

import contextlib
import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

KINDS = (  # first match wins, on the device kernel's name; cuDNN's convolutions
    # run as implicit GEMMs (fprop/dgrad/wgrad), so they are matched before GEMMs
    ("port kernels (G, G-bwd, C, C-bwd, S, K5)",
     r"gather_levels|sort_composite|ray_som|bn_(stats|apply|bwd|forward|backward|grads)"),
    ("convolution (cuDNN)", r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|cudnn"),
    ("GEMM (cuBLAS)", r"gemm|cutlass|splitK|nvjet"),
    ("reduction", r"reduce|norm|softmax|cumprod|cumsum|scan|sort|radix"),
    ("index / gather / scatter", r"index|gather|scatter|embedding"),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "elementwise and other"


class Brackets:
    """(label, start ns, end ns) on the host's perf_counter clock."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, label: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.perf_counter_ns()))

    def durations_ms(self, label: str) -> List[float]:
        return [(b - a) / 1e6 for name, a, b in self.spans if name == label]


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of (start, end) intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


class Trace:
    """The device operations of a traced block, on the trace's clock (us)."""

    def __init__(self, events: List[dict], t_start_ns: int, t_end_ns: int,
                 brackets: List[Tuple[str, int, int]]):
        ops = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: float(e["ts"]))
        if len(ops) < 3:
            raise ValueError(f"the trace holds {len(ops)} device operations: no markers")
        first, last = ops[0], ops[-1]
        self.marker_names = (first["name"], last["name"])
        # the first marker was launched at t_start_ns, right after a synchronize
        self.offset_us = float(first["ts"]) - t_start_ns / 1e3
        self.align_error_us = float(last["ts"]) - (t_end_ns / 1e3 + self.offset_us)
        self.t0 = float(first["ts"]) + float(first["dur"])
        self.t1 = float(last["ts"])
        self.ops = [(e["name"], e["cat"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in ops[1:-1]]
        self.brackets = [(lab, a / 1e3 + self.offset_us, b / 1e3 + self.offset_us)
                         for lab, a, b in brackets]

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> Tuple[float, List[Tuple[float, float]]]:
        return union_us([(max(a, self.t0), min(b, self.t1)) for _, _, a, b in self.ops
                         if b > self.t0 and a < self.t1])

    def kernels(self, pattern: Optional[str] = None) -> List[Tuple[str, float]]:
        """(name, duration us) of each kernel, those whose name matches
        `pattern` where given."""
        rx = re.compile(pattern) if pattern else None
        return [(n, b - a) for n, cat, a, b in self.ops
                if cat == "kernel" and (rx is None or rx.search(n))]

    def label_at(self, t: float) -> str:
        inside = [lab for lab, a, b in self.brackets if a <= t < b]
        return inside[-1] if inside else "between calls"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(label, seconds) of every gap between busy intervals in the
        window, longest first."""
        _, merged = self.busy()
        edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return sorted(((self.label_at(a), (b - a) / 1e6) for a, b in gaps),
                      key=lambda g: -g[1])

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The n device operations that took most time, summed by name and
        prefixed by their kind, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, cat, a, b in self.ops:
            by_name[name] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [(f"{kind_of(k)}: {k[:160]}", v / 1e6) for k, v in top]

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, cat, a, b in self.ops:
            out[kind_of(name) if cat == "kernel" else cat] += (b - a) / 1e6
        return dict(out)


@contextlib.contextmanager
def profiled(out_path: Path, brackets: Brackets, holder: dict):
    """Trace the block inside with CUDA activity only; on exit parse the
    trace into holder["trace"] (a `Trace`) and delete the file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(7, device="cuda")
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                   with_stack=False, profile_memory=False)
    prof.__enter__()
    try:
        torch.cuda.synchronize()
        t_start = time.perf_counter_ns()
        marker.fill_(1.0)
        yield
        torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
        marker.fill_(2.0)
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    events = json.loads(out_path.read_text())["traceEvents"]
    out_path.unlink()
    holder["trace"] = Trace(events, t_start, t_end, brackets.spans)
