"""backward_host_ms.train: the host time of the program's `backward` spans
(`loss.backward()` in `Trainer.train_step`) in the traced training steps,
per step, in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    return spans.host_ms(rec, "train", ["backward"], rec.profiled_units)
