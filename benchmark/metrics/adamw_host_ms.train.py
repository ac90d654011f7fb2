"""adamw_host_ms.train: the host time of the program's `adamw` spans (the
optimizer's `step()` in `Trainer.train_step`) in the traced training steps,
per step, in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "train", ["adamw"], rec.profiled_units)
