"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): HBM bytes a second and float32 operations a
second on the CUDA cores (outside the tensor cores; TF32 is off)."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time in ms that moving ``n_bytes`` and computing
    ``n_ops`` float32 operations take at the peaks."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS) * 1e3
