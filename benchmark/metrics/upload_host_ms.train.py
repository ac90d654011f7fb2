"""upload_host_ms.train: the host time of the program's `upload` spans
(`Trainer.device_batch`: the batch's copies to the card and the sphere-map
cache) in the traced training steps, per step, in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "train", ["upload"], rec.profiled_units)
