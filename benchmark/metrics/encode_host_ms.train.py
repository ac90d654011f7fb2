"""encode_host_ms.train: the host time of the program's `encode` spans (the
body of `SceneRF.encode`: B7 and the sphere decoder) in the traced training
steps, per step, in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "train", ["encode"], rec.profiled_units)
