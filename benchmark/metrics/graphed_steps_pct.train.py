"""graphed_steps_pct.train: the share of the traced training steps whose
blocks replayed CUDA graphs, in %: the `train_step` spans whose
`graph_replay` counter (`Trainer.train_step`: 1 on a step that replayed,
the step that captured them included) is set, over the `train_step` spans
of the traced window. 0 from a program that counts no replay; None without
the recorder."""
from benchmark.harness.cell import BENCH, load_module

spans = load_module(BENCH / "metrics" / "_spans.py")


def read(rec):
    found = spans.spans(rec, ["train_step"]) if rec.kind == "train" else None
    if found is None:
        return None
    return 100.0 * sum(1 for _, _, c in found if c.get("graph_replay", 0)) / len(found)
