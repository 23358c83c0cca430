"""Data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity, at the
full 700 W power limit): the yardstick every work count is held to."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: FP32 outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
#: int8 tensor cores, operations/s (one multiply-add is two operations)
INT8_OPS = 1979e12


def bound_s(nbyte=0.0, fp32_flop=0.0, int8_op=0.0):
    """The least time the card could take for this work: the largest of
    bytes over bandwidth and each kind of operation over its peak."""
    return max(nbyte / HBM_BYTES_S, fp32_flop / FP32_FLOPS,
               int8_op / INT8_OPS)
