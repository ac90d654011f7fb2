"""The controls: the reference computed one precision below the one its
configuration states. For bfloat16, fp8: every input of a convolution or a
matrix product rounded to float8_e4m3fn after scaling its largest magnitude
to the format's largest (per tensor, as fp8 training scales), then scaled
back, the product taken in f32. For float32, TF32: the reference with
`allow_tf32` on for cuBLAS and cuDNN."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to e4m3 under a per-tensor scale, returned in its dtype."""
    if not t.is_floating_point():
        return t
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


_PRODUCTS = {F.linear: 2, F.conv2d: 2, torch.matmul: 2, torch.mm: 2, torch.bmm: 2,
             torch.Tensor.matmul: 2, torch.Tensor.__matmul__: 2}


class Fp8Products(TorchFunctionMode):
    """Round the first two tensor arguments of every convolution and matrix
    product to fp8 (straight through: the rounding has gradient 1)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _PRODUCTS.get(func)
        if n:
            args = tuple(_ste(a) if i < n and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


def _ste(t: torch.Tensor) -> torch.Tensor:
    return t + (fp8_round(t) - t).detach()


@contextlib.contextmanager
def lowered(dtype: str):
    """The control's precision for a configuration stating `dtype`."""
    if dtype == "bfloat16":
        with Fp8Products():
            yield
        return
    if dtype == "float32":
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return
    raise ValueError(f"no control for {dtype!r}")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN: float32 is float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
