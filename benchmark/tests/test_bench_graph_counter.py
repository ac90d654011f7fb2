"""The reader of the program's `graph_replay` counter, `graphed_steps_pct.train`,
on synthetic spans with hand-computed answers: the share of the traced
`train_step` spans that carry the counter; 0 for spans without it (a
program that replays no graph); None outside training runs, without a
trace, and with a program that has no recorder."""
import sys
from types import SimpleNamespace

import pytest

import scenerf_tpu_torch.utils as program_utils
from benchmark.harness.cell import Cell, load_spec
from benchmark.harness.trace import Trace
from scenerf_tpu_torch.utils import tracing
from scenerf_tpu_torch.utils.tracing import Span

SPEC = load_spec()
NAME = "graphed_steps_pct.train"


def trace():
    """Markers at 100 and 1000 us, the traced window 105-1000 us (host ns =
    us x 1e3), one kernel inside it."""
    ev = lambda name, ts: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 5}
    return Trace([ev("fill marker", 100), ev("gemm", 400), ev("fill marker", 1000)],
                 100_000, 1_000_000, [])


def step(i, a_us, b_us, **counts):
    return Span("train_step", i, 0, i, int(a_us * 1e3), int(b_us * 1e3), counts)


def stage(i, parent, a_us, b_us, **counts):
    return Span("encode", i, parent, parent, int(a_us * 1e3), int(b_us * 1e3), counts)


def read(spans, monkeypatch, kind="train", tr=True):
    monkeypatch.setattr(tracing, "snapshot", lambda: spans)
    rec = SimpleNamespace(kind=kind, trace=trace() if tr else None, profiled_units=4,
                          profiled_encodes=0)
    return Cell(SPEC, "kitti-train-bf16").metric_reader(NAME).read(rec)


def test_the_metric_is_in_the_spec():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["kitti-train-bf16", "bf-train-f32"]
    assert (m["unit"], m["source"], m["moves"]) == ("%", "program_counter", "train_rays_per_s")


@pytest.mark.parametrize("spans, share", [
    # four steps, all replayed (the first one captured them too)
    ((step(1, 110, 300, graph_capture=1, graph_replay=1, h2d_bytes=8),
      step(2, 300, 500, graph_replay=1), step(3, 500, 700, graph_replay=1),
      step(4, 700, 990, graph_replay=1)), 100.0),
    # an eager first step of a shape, then one that captured, then two replays;
    # a stage span's counter and a step after the window are left out
    ((step(1, 110, 300, h2d_bytes=8), stage(9, 1, 120, 200, graph_replay=1),
      step(2, 300, 500, graph_capture=1, graph_replay=1), step(3, 500, 700, graph_replay=1),
      step(4, 700, 990, graph_replay=1), step(5, 2000, 3000, graph_replay=1)), 75.0),
    # a program without the counter: its steps replay nothing
    ((step(1, 110, 500, h2d_bytes=8), step(2, 500, 990)), 0.0),
])
def test_share_of_graphed_steps(spans, share, monkeypatch):
    assert read(spans, monkeypatch) == pytest.approx(share)


def test_none_without_steps_a_trace_or_the_recorder(monkeypatch):
    spans = (step(1, 110, 500, graph_replay=1),)
    assert read(spans, monkeypatch, kind="sweep") is None
    assert read(spans, monkeypatch, tr=False) is None
    assert read((stage(1, 0, 110, 500),), monkeypatch) is None
    # an older program: no scenerf_tpu_torch.utils.tracing to import
    monkeypatch.delattr(program_utils, "tracing")
    monkeypatch.setitem(sys.modules, "scenerf_tpu_torch.utils.tracing", None)
    assert read(spans, monkeypatch) is None
