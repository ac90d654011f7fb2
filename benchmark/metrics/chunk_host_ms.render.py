"""chunk_host_ms.render: the mean host time of the program's `chunk` spans
(`rendering.render_rays`, one `render_ray_block` of rays) in the traced
sweep, in ms."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    found = spans.spans(rec, ["chunk"]) if rec.kind == "sweep" else None
    return None if found is None else sum(b - a for a, b, _ in found) / 1e3 / len(found)
