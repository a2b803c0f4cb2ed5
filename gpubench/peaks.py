"""The table of peaks the rooflines are held to.

NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet, at its 700 W power
limit: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores. A card set below 700 W runs slower under load, so a share against
these peaks is a lower bound of the share against that card's own.
"""

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_s(nbytes: float = 0.0, f32_ops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_S, f32_ops / F32_OPS_S)
