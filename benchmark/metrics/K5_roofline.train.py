"""K5_roofline.train: kernel K5's least time in the traced training steps
(benchmark/counts/norm.py: every batch norm site's forward and backward,
per step, times the steps) over the device time of the trace's `bn_*`
kernels, in %."""

PATTERN = r"\bbn_\w*kernel"


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    spent_us = sum(d for _, d in rec.trace.kernels(PATTERN))
    if spent_us <= 0:
        return None
    return 100.0 * rec.work["K5_s"] * rec.profiled_units / (spent_us / 1e6)
