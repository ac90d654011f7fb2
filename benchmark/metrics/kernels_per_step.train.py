"""kernels_per_step.train: the device kernels of the traced training steps
over the steps."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.profiled_units:
        return None
    return len(rec.trace.kernels()) / rec.profiled_units
