"""Kernel K5's bytes and operations (batch norm + activation + residual),
after the program's `chip_smoke.py` bounds of the one-launch design, in
training: forward x (and the residual) read once and y written, (7 + act)
operations an element; backward x, dy (and the residual where the
activation needs z) read once, dx (and the residual's gradient) written,
(11 + 2 act') operations an element; its arithmetic is f32 in both
dtypes. Counted per site of the encoder and decoder (192 at B7), per step.
"""
from __future__ import annotations

from benchmark.counts.peaks import bound_s

ACT_OPS = {"identity": 0, "silu": 4, "leaky": 2}        # per element, forward
ACT_GRAD_OPS = {"identity": 0, "silu": 7, "leaky": 2}   # per element, act'(z)


def site_s(rows: int, channels: int, act: str, residual: bool, itemsize: int) -> float:
    """The least time of one site's forward and backward in training."""
    n = rows * channels
    e = n * itemsize
    fwd = bound_s(e * (2 + residual), (7 + ACT_OPS[act]) * n)
    r_read = residual and act != "identity"
    bwd = bound_s(e * (3 + r_read + residual), (11 + 2 * ACT_GRAD_OPS[act]) * n)
    return fwd + bwd


def train_step_s(bn_sites, itemsize: int) -> float:
    return sum(site_s(m, c, act, res, itemsize) for m, c, act, res in bn_sites)
