"""idle_pct.train: the share of the traced training steps' wall time in
which no operation ran on the device: 100 less the union of the trace's
kernel, copy and set intervals over the traced window, in %."""


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    busy_us, _ = rec.trace.busy()
    return 100.0 * (1.0 - busy_us / rec.trace.window_us)
