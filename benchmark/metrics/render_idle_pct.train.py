"""render_idle_pct.train: the device's idle time inside the program's
`render_train` and `render_gt` spans (`SceneRF._per_source`: each source's
training render with its losses, and its GT-depth render), over the traced
training steps' window, in %. The stages do not overlap, so the five
`*_idle_pct.train` add up to at most `idle_pct.train`."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.idle_pct(rec, "train", ["render_train", "render_gt"])
