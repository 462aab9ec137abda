"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit): FLOP/s by compute
precision, and HBM3 bytes per second."""

FLOPS = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8_e4m3": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, n_bytes: float, precision: str = "float32") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / FLOPS[precision], n_bytes / HBM_BYTES_PER_S)
