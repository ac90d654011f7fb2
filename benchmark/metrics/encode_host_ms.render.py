"""encode_host_ms.render: the host time of the program's `encode` span (the
body of `SceneRF.encode`) in the traced sweep, per encode, in ms: the
enqueue, where `encode_ms.render` waits for the device."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "sweep", ["encode"], rec.profiled_encodes)
