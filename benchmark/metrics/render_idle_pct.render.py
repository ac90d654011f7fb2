"""render_idle_pct.render: the device's idle time inside the program's
`render_image` spans (`SceneRF.render_image`, a pose), over the traced
sweep's window, in %."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.idle_pct(rec, "sweep", ["render_image"])
