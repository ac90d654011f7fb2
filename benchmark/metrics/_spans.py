"""What the readers of the program's own spans share. The program records
spans and counters (`scenerf_tpu_torch/utils/tracing.py`) while a
torch.profiler session is active, so a traced run records those of its
traced steps or poses with no help from the benchmark. Their times are
`time.perf_counter_ns()`, the host clock the trace's first marker is
aligned to, so `Trace.offset_us` places them on the device trace. A program
without the recorder (an older commit) gives None everywhere here."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from benchmark.harness.trace import union_us


def spans(rec, names: Optional[Iterable[str]] = None
          ) -> Optional[List[Tuple[float, float, dict]]]:
    """(start, end) on the trace's clock in us, and the counters, of each
    span named in `names` (any name: None) that overlaps the traced window;
    None without a trace, without the recorder, or where no such span was
    recorded."""
    if rec.trace is None:
        return None
    try:
        from scenerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    tr, names = rec.trace, None if names is None else set(names)
    out = []
    for s in tracing.snapshot():
        a, b = s.start / 1e3 + tr.offset_us, s.end / 1e3 + tr.offset_us
        if (names is None or s.name in names) and b > tr.t0 and a < tr.t1:
            out.append((a, b, s.counts))
    return out or None


def host_ms(rec, kind: str, names: Iterable[str], per: int) -> Optional[float]:
    """The host time of the spans named in `names`, summed and divided by
    `per` (steps, poses or encodes), in ms; None outside runs of `kind`."""
    found = spans(rec, names) if rec.kind == kind and per else None
    return None if found is None else sum(b - a for a, b, _ in found) / 1e3 / per


def overlap_us(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(rec, kind: str, names: Iterable[str]) -> Optional[float]:
    """The device's idle time inside the union of the spans named in
    `names` (the complement of the trace's busy intervals, intersected with
    the spans cut to the traced window), over the traced window, in %; None
    outside runs of `kind`."""
    found = spans(rec, names) if rec.kind == kind else None
    if found is None:
        return None
    tr = rec.trace
    inside, stage = union_us([(max(a, tr.t0), min(b, tr.t1)) for a, b, _ in found])
    _, busy = tr.busy()
    return 100.0 * (inside - overlap_us(stage, busy)) / tr.window_us
