"""render_host_ms.train: the host time of the program's `render_train` and
`render_gt` spans (`SceneRF._per_source`: each source's training render with
its losses, and its GT-depth render) in the traced training steps, per step,
in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "train", ["render_train", "render_gt"], rec.profiled_units)
