"""G_roofline.train: kernel G's least time in the traced training steps
(benchmark/counts/gather.py, per step, times the steps) over the device time
of the trace's `gather_levels_kernel` launches, in %."""

PATTERN = r"gather_levels_kernel"


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    spent_us = sum(d for _, d in rec.trace.kernels(PATTERN))
    if spent_us <= 0:
        return None
    return 100.0 * rec.work["G_s"] * rec.profiled_units / (spent_us / 1e6)
