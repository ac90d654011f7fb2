"""mfu.render: the window's model FLOPs (each pose's renders and each
frame's encode, counted by benchmark/counts/model_flops.py from the cell's
shapes) over the window's wall time, as a share of the card's peak in the
configuration's stated dtype, in %."""


def read(rec):
    if rec.kind != "sweep" or not rec.window["units"]:
        return None
    w, win = rec.work, rec.window
    flops = w["pose_flops"] * win["units"] + w["encode_flops"] * win["encodes"]
    return 100.0 * flops / win["seconds"] / w["peak_flops"]
