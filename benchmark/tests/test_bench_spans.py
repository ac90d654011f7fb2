"""The readers of the program's spans (`metrics/_spans.py` and the metrics
that load it) on a synthetic trace and synthetic spans with hand-computed
answers; the five train idle shares within `idle_pct.train`; None outside
their kind, without a trace, and with a program that has no recorder; and
every train and sweep reader on the spans of a real `tiny` step and render."""
import sys
import time
from types import SimpleNamespace

import pytest
import torch

import scenerf_tpu_torch.utils as program_utils
from benchmark.harness.cell import Cell, load_spec
from benchmark.harness.trace import Trace
from scenerf_tpu_torch.utils import tracing
from scenerf_tpu_torch.utils.tracing import Span

SPEC = load_spec()
NEW = {m["name"]: m for m in SPEC["per_layer"]
       if m["name"].startswith(("upload_", "encode_host", "encode_idle", "render_",
                                "backward_", "adamw_", "h2d_", "chunk_"))}
TRAIN = [n for n in NEW if n.endswith(".train")]
SWEEP = [n for n in NEW if n.endswith(".render")]
IDLE_TRAIN = [n for n in TRAIN if "_idle_pct" in n]


def read(name, rec):
    return Cell(SPEC, NEW[name]["workloads"][0]).metric_reader(name).read(rec)


def trace(t_start_ns=100_000, t_end_ns=1_000_000):
    """Markers at 100 and 1000 us (the window 105-1000 us, host ns = us x
    1e3); busy 200-400, 500-550, 600-670, 700-800 us: 420 of 895 us."""
    ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [ev("fill marker", 100, 5), ev("gemm", 200, 200), ev("copy", 500, 50),
              ev("gather", 600, 70), ev("bn", 700, 100), ev("fill marker", 1000, 5)]
    return Trace(events, t_start_ns, t_end_ns, [])


def span(name, i, parent, a_us, b_us, **counts):
    return Span(name, i, parent, 1, int(a_us * 1e3), int(b_us * 1e3), counts)


# a train step's stages, us: idle 105-200, 400-500, 550-600, 670-700, 800-1000
TRAIN_SPANS = (
    span("train_step", 1, 0, 110, 990),
    span("upload", 2, 1, 120, 180, h2d_bytes=3_000_000),  # idle 60
    span("encode", 3, 1, 180, 450),          # busy 200-400: idle 20 + 50
    span("render_train", 4, 1, 450, 560),    # busy 500-550: idle 60
    span("chunk", 5, 4, 460, 540),
    span("render_gt", 6, 1, 560, 640),       # busy 600-640: idle 40
    span("backward", 7, 1, 640, 760),        # busy 640-670, 700-760: idle 30
    span("adamw", 8, 1, 760, 900),           # busy 760-800: idle 100
    span("encode", 9, 0, 2000, 3000),        # after the window: left out
)
# a sweep: an encode, then a pose of two chunks
SWEEP_SPANS = (
    span("encode", 1, 0, 110, 300),          # busy 200-300: idle 90
    span("render_image", 2, 0, 300, 990),    # busy 320 of 690: idle 370
    span("chunk", 3, 2, 320, 420),
    span("chunk", 4, 2, 420, 520),
)


def rec(kind, spans, monkeypatch, units=2, encodes=0, tr=True):
    monkeypatch.setattr(tracing, "snapshot", lambda: spans)
    return SimpleNamespace(kind=kind, trace=trace() if tr else None, profiled_units=units,
                           profiled_encodes=encodes)


def test_the_new_metrics_are_in_the_spec():
    assert len(NEW) == 15 and len(TRAIN) == 11 and len(SWEEP) == 4
    for name, m in NEW.items():
        cells = ["kitti-sweep-bf16"] if name in SWEEP else ["kitti-train-bf16", "bf-train-f32"]
        assert m["workloads"] == cells
        assert m["source"] == ("device_trace" if "_idle_pct" in name else "host_clock")


def test_train_readers_on_synthetic_spans(monkeypatch):
    r = rec("train", TRAIN_SPANS, monkeypatch)
    expected = {
        "upload_host_ms.train": 0.060 / 2, "encode_host_ms.train": 0.270 / 2,
        "render_host_ms.train": (0.110 + 0.080) / 2, "backward_host_ms.train": 0.120 / 2,
        "adamw_host_ms.train": 0.140 / 2, "h2d_mb.train": 1.5,
        "upload_idle_pct.train": 100 * 60 / 895, "encode_idle_pct.train": 100 * 70 / 895,
        "render_idle_pct.train": 100 * 100 / 895, "backward_idle_pct.train": 100 * 30 / 895,
        "adamw_idle_pct.train": 100 * 100 / 895,
    }
    assert set(expected) == set(TRAIN)
    for name, value in expected.items():
        assert read(name, r) == pytest.approx(value), name
    for name in SWEEP:
        assert read(name, r) is None, name
    idle = Cell(SPEC, "kitti-train-bf16").metric_reader("idle_pct.train").read(r)
    shares = sum(read(n, r) for n in IDLE_TRAIN)
    assert idle == pytest.approx(100 * 475 / 895) and shares == pytest.approx(100 * 360 / 895)


def test_sweep_readers_on_synthetic_spans(monkeypatch):
    r = rec("sweep", SWEEP_SPANS, monkeypatch, units=1, encodes=1)
    expected = {"encode_host_ms.render": 0.190, "encode_idle_pct.render": 100 * 90 / 895,
                "render_idle_pct.render": 100 * 370 / 895, "chunk_host_ms.render": 0.100}
    for name, value in expected.items():
        assert read(name, r) == pytest.approx(value), name
    for name in TRAIN:
        assert read(name, r) is None, name


def test_none_without_a_trace_or_without_the_recorder(monkeypatch):
    r = rec("train", TRAIN_SPANS, monkeypatch, tr=False)
    assert all(read(n, r) is None for n in TRAIN)
    r = rec("train", (), monkeypatch)
    assert all(read(n, r) is None for n in TRAIN)
    # an older program: no scenerf_tpu_torch.utils.tracing to import
    r = rec("train", TRAIN_SPANS, monkeypatch)
    monkeypatch.delattr(program_utils, "tracing")
    monkeypatch.setitem(sys.modules, "scenerf_tpu_torch.utils.tracing", None)
    assert all(read(n, r) is None for n in TRAIN)


def test_readers_on_the_spans_of_a_tiny_step_and_render():
    """The program's real span names reach every reader: a `tiny` step and
    an encode and a pose recorded, on a trace whose window holds them."""
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.train import Trainer

    cfg = C.tiny()
    trainer, batch = Trainer(cfg, device="cpu", seed=0), make_batch(cfg)
    cam_K = torch.as_tensor(batch["cam_K"][0])

    def traced(call, kind):
        with tracing.recording():
            t0 = time.perf_counter_ns()
            call()
            t1 = time.perf_counter_ns()
        ev = lambda ts: {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": 1}
        tr = Trace([ev(t0 / 1e3), ev((t0 + t1) / 2e3), ev(t1 / 1e3)], t0, t1, [])
        return SimpleNamespace(kind=kind, trace=tr, profiled_units=1, profiled_encodes=1)

    r = traced(lambda: trainer.train_step(batch), "train")
    values = {n: read(n, r) for n in TRAIN}
    assert all(v is not None for v in values.values()), values
    assert values["h2d_mb.train"] == 0.0  # a CPU run copies nothing to a card
    assert sum(values[n] for n in IDLE_TRAIN) <= 100.0

    def sweep():
        model = trainer.model.eval()
        levels = model.encode(torch.as_tensor(batch["img_input"]), cam_K)
        model.render_image(model.pyramid_for_item(levels, 0), cam_K, torch.eye(4),
                           torch.Generator().manual_seed(0), stride=2)

    r = traced(sweep, "sweep")
    assert all(read(n, r) is not None for n in SWEEP)
