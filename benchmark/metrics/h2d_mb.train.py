"""h2d_mb.train: the program's `h2d_bytes` counter (`model.to_device`: the
bytes of each host tensor copied to the card) over the traced training
steps, per step, in MB (1e6 bytes)."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    found = spans.spans(rec) if rec.kind == "train" and rec.profiled_units else None
    if found is None:
        return None
    return sum(c.get("h2d_bytes", 0) for _, _, c in found) / rec.profiled_units / 1e6
