"""Rounding to a lower precision than float32, for the controls: TF32
keeps float32's exponent and 10 of its 23 mantissa bits."""

import torch


def round_tf32(x):
    """``x`` (float32, or complex64 by its parts) rounded to the nearest
    TF32 value, ties to even."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    b = x.contiguous().view(torch.int32)
    keep = (b >> 13) & 1
    b = (b + 0x0FFF + keep) & ~0x1FFF
    return b.view(torch.float32)
