"""launch_ms.train: the host's time for a `Trainer.train_step` call to
return (no synchronize), the mean over the window's steps, in ms, from the
benchmark's own bracket around the call."""

import statistics


def read(rec):
    if rec.kind != "train":
        return None
    times = rec.brackets.durations_ms("train_step")
    return statistics.fmean(times) if times else None
