"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense, at the 700 W power limit): the denominators of every roofline
share.  Operations are counted one each (a multiply, an add, a compare),
so the float32 rate is the sheet's 67 TFLOP/s, which counts a fused
multiply-add as two: a kernel that fuses every pair reaches it."""

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67.0e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory's rate and the operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S)
