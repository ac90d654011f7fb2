"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
BF16_FLOPS = 989e12   # dense bf16 on the tensor cores


def flops(dtype: str) -> float:
    """The peak of the compute dtype a configuration states."""
    return {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}[dtype]


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float = F32_FLOPS) -> float:
    """The least time of a piece of work: the larger of its bytes over the
    HBM rate and its operations over the peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
