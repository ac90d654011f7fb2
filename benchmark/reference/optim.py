"""AdamW, written out: the update the training step's optimizer has to make
from a gradient and its moments (decoupled weight decay, bias-corrected
moments, eps added to the root of the second one), in float64."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def adamw_step(p: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
               v: Optional[torch.Tensor], t: int, lr: float,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0) -> torch.Tensor:
    """The parameter `p` after the `t`-th step (t >= 1) with gradient `g`
    and the moments `m`, `v` the previous steps left (None: none yet), as
    float64."""
    b1, b2 = betas
    p, g = p.double(), g.double()
    m = torch.zeros_like(p) if m is None else m.double()
    v = torch.zeros_like(p) if v is None else v.double()
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    m_hat = m / (1.0 - b1 ** t)
    root_v_hat = torch.sqrt(v) / math.sqrt(1.0 - b2 ** t)
    return p * (1.0 - lr * weight_decay) - lr * m_hat / (root_v_hat + eps)
