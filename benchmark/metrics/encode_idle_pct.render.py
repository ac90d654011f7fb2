"""encode_idle_pct.render: the device's idle time inside the program's `encode`
spans (the body of `SceneRF.encode`), over the traced sweep's window, in %."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.idle_pct(rec, "sweep", ["encode"])
