"""The program's spans and counters (`scenerf_tpu_torch/utils/tracing.py`)
on one `tiny` training step and one render on the CPU: nothing is recorded
by default; under `tracing.recording()` and under a CPU `torch.profiler`
session the step's span tree is `train_step` over `upload`, `encode`,
`render_train` and `render_gt` per source (each over its `chunk`s),
`backward` and `adamw`, its ids, parents and roots consistent and every
interval inside its parent's and inside the call; recording stops with the
profiler; the buffer keeps its bound. The `h2d_bytes` counter of a batch's
upload needs a card (`-m cuda`); this file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""
import threading
import time

import pytest
import torch

from scenerf_tpu_torch import config as C
from scenerf_tpu_torch.data.synthetic import make_batch
from scenerf_tpu_torch.train import Trainer
from scenerf_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    cfg = C.tiny()
    trainer = Trainer(cfg, device="cpu", seed=0)
    return cfg, trainer, make_batch(cfg)


def clear() -> None:
    with tracing.recording():
        pass


def spans_of(call):
    """The spans recorded by `call()`, and the host clock read around it."""
    t0 = time.perf_counter_ns()
    call()
    t1 = time.perf_counter_ns()
    return [s for s in tracing.snapshot() if s.start >= t0], t0, t1


def render(cfg, trainer, batch):
    model = trainer.model.eval()
    cam_K = torch.as_tensor(batch["cam_K"][0])
    levels = model.encode(torch.as_tensor(batch["img_input"]), cam_K)
    model.render_image(model.pyramid_for_item(levels, 0), cam_K, torch.eye(4),
                       torch.Generator().manual_seed(0), stride=2)


def check_tree(spans, t0: int, t1: int) -> None:
    """Ids unique, each parent recorded, each child's root its parent's,
    each interval inside its parent's and inside [t0, t1]."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert t0 <= s.start <= s.end <= t1
        if s.parent:
            p = by_id[s.parent]
            assert s.root == p.root and p.start <= s.start <= s.end <= p.end


def test_recording_is_off_by_default(run):
    cfg, trainer, batch = run
    clear()
    trainer.train_step(batch)
    render(cfg, trainer, batch)
    assert tracing.snapshot() == ()
    # off, a span is one shared empty context and a count is dropped
    assert tracing.span("a") is tracing.span("b", 3)
    with tracing.span("a"):
        tracing.count("h2d_bytes", 5)
    assert tracing.snapshot() == ()


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_span_tree_of_a_step(run, how):
    cfg, trainer, batch = run
    clear()
    step = trainer.step
    if how == "recording":
        with tracing.recording():
            spans, t0, t1 = spans_of(lambda: trainer.train_step(batch))
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            spans, t0, t1 = spans_of(lambda: trainer.train_step(batch))
    check_tree(spans, t0, t1)
    roots = [s for s in spans if s.parent == 0]
    assert [(s.name, s.root) for s in roots] == [("train_step", step)]
    children = sorted((s for s in spans if s.parent == roots[0].id), key=lambda s: s.start)
    per_source = ["render_train", "render_gt"] * cfg.n_sources
    assert [s.name for s in children] == ["upload", "encode", *per_source, "backward", "adamw"]
    for s in children:
        n_chunks = sum(c.parent == s.id for c in spans)
        rays, chunk = {"render_train": (cfg.n_rays, cfg.ray_chunk),
                       "render_gt": (cfg.n_gt_depth, cfg.eval_ray_chunk)}.get(s.name, (0, 1))
        assert n_chunks == -(-rays // chunk), s.name
    assert all(s.name == "chunk" for s in spans if s.parent not in (0, roots[0].id))
    # the stages on the main thread are disjoint
    stages = [(s.start, s.end) for s in children]
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_spans_of_a_render(run):
    cfg, trainer, batch = run
    with tracing.recording():
        spans, t0, t1 = spans_of(lambda: render(cfg, trainer, batch))
    check_tree(spans, t0, t1)
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["encode", "render_image"]
    assert all(s.root == s.id for s in roots)  # a per-call number
    W, H = cfg.img_size
    chunks = [s for s in spans if s.parent == roots[1].id]
    assert len(chunks) == len(spans) - 2 == -(-(W // 2) * (H // 2) // cfg.eval_ray_chunk)


def test_recording_stops_when_the_profiler_exits():
    clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("inside"):
            tracing.count("n", 2)
    with tracing.span("after"):
        tracing.count("n", 3)
    assert [(s.name, s.counts) for s in tracing.snapshot()] == [("inside", {"n": 2})]


def test_counts_go_to_the_innermost_span_of_the_thread():
    def other():
        with tracing.span("other"):
            tracing.count("n", 7)

    with tracing.recording():
        tracing.count("n", 1)  # no span open: not recorded
        with tracing.span("outer", 4):
            tracing.count("n", 2)
            with tracing.span("inner"):
                tracing.count("n", 3)
                tracing.count("n", 4)
                worker = threading.Thread(target=other)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
    got = {s.name: s for s in tracing.snapshot()}
    assert {k: s.counts for k, s in got.items()} == {
        "inner": {"n": 7}, "outer": {"n": 2}, "other": {"n": 7}}
    assert got["outer"].root == got["inner"].root == 4 and got["inner"].parent == got["outer"].id
    assert got["other"].parent == 0 and got["other"].root == got["other"].id


def test_the_buffer_keeps_its_bound():
    with tracing.recording():
        for i in range(tracing.MAX_SPANS + 10):
            with tracing.span("s", i):
                pass
    spans = tracing.snapshot()
    assert len(spans) == tracing.MAX_SPANS
    assert [s.root for s in spans[:2]] == [10, 11] and spans[-1].root == tracing.MAX_SPANS + 9


@pytest.mark.cuda
def test_h2d_bytes_counts_the_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counter counts copies to a card")
    cfg = C.tiny()
    trainer = Trainer(cfg, device="cuda", seed=0)
    batch = make_batch(cfg)
    with tracing.recording():
        trainer.device_batch(batch)
    (upload,) = tracing.snapshot()
    assert upload.name == "upload"
    assert upload.counts == {"h2d_bytes": sum(4 * v.size for v in batch.values())}
