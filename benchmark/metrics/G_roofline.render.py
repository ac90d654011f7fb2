"""G_roofline.render: kernel G's least time in the traced encode and poses
(benchmark/counts/gather.py: the encode's sphere resamples and each pose's
render) over the device time of the trace's `gather_levels_kernel`
launches, in %."""

PATTERN = r"gather_levels_kernel"


def read(rec):
    if rec.kind != "sweep" or rec.trace is None:
        return None
    spent_us = sum(d for _, d in rec.trace.kernels(PATTERN))
    if spent_us <= 0:
        return None
    w = rec.work
    least = w["G_pose_s"] * rec.profiled_units + w["G_encode_s"] * rec.profiled_encodes
    return 100.0 * least / (spent_us / 1e6)
