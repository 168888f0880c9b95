"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W):
HBM bandwidth and float32 outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def least_s(nbytes: float, flops: float) -> float:
    """The least time of work that moves ``nbytes`` and does ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
