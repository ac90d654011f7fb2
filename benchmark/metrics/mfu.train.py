"""mfu.train: the window's model FLOPs (a step's, counted by
benchmark/counts/model_flops.py from the cell's shapes, times the steps)
over the window's wall time, as a share of the card's peak in the
configuration's stated dtype, in %."""


def read(rec):
    if rec.kind != "train" or not rec.window["units"]:
        return None
    w = rec.work
    return 100.0 * w["flops"] * rec.window["units"] / rec.window["seconds"] / w["peak_flops"]
