"""encode_ms.render: the host clock around a frame's upload and
`SceneRF.encode`, ended by a synchronize, the mean over the window's
encodes, in ms."""

import statistics


def read(rec):
    if rec.kind != "sweep":
        return None
    times = rec.brackets.durations_ms("encode")
    return statistics.fmean(times) if times else None
