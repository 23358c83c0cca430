"""Linear-algebra helpers of the beamformer engine (a subset of
``bifrost_tpu/ops/linalg.py``).

The port carries what ``ops/beamform.py`` needs: the environment
switches :func:`_force_env` and :func:`_probe_wanted`, the bf16 plane
products :func:`_split_hilo`, :func:`_mm_hilo` and :func:`_mm_bf16`, and
the f32 accuracy-gate bound :data:`GATE_RTOL` (``LinAlg._GATE_RTOL``).
The ``LinAlg`` class, its GEMM and X-engine candidates and the Pallas
correlation kernels are not ported yet (the FX-correlator slice).

torch has no ``preferred_element_type``: a bf16 product with a float32
result is taken here as the float32 product of bf16-rounded operands,
which is exact per term (a bf16 x bf16 product fits float32's mantissa)
and sums in float32, the semantics of the JAX package's bf16 MXU passes.
"""

from __future__ import annotations

import os

__all__ = ['GATE_RTOL', '_force_env', '_probe_wanted', '_split_hilo',
           '_mm_hilo', '_mm_bf16']

#: a candidate deviating from the baseline by more than this (relative
#: to the baseline's maximum, at the actual shape) is kept out of a speed
#: race; the bound admits the hi-lo split's ~2^-16 truncation and catches
#: a broken candidate (``LinAlg._GATE_RTOL``, ``linalg.py:434``)
GATE_RTOL = 1e-3


def _force_env(var, allowed):
    v = os.environ.get(var, '').strip().lower()
    return v if v in allowed else None


def _probe_wanted():
    """``BF_LINALG_PROBE``: probe on the card unless '0', probe anywhere
    when '1' (the JAX rule, with "on TPU" read as "on the card")."""
    probe_env = os.environ.get('BF_LINALG_PROBE', '').strip()
    if probe_env == '1':
        return True
    if probe_env == '0':
        return False
    from ..device import on_cuda
    return on_cuda()


def _bf16(x):
    """``x`` rounded to bf16 (nearest even), held as float32."""
    import torch
    return x.to(torch.bfloat16).float()


def _split_hilo(x):
    """float32 -> (hi, lo), both bf16-valued float32, with x == hi + lo
    up to bf16(lo) rounding (lo carries the next 8 mantissa bits)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm_hilo(a, b):
    """f32-accuracy-class matmul as three bf16 products with float32
    accumulation (the lo @ lo term dropped, ~2^-16 relative)."""
    import torch
    ah, al = _split_hilo(a.float())
    bh, bl = _split_hilo(b.float())
    return (torch.matmul(ah, bh)
            + (torch.matmul(ah, bl) + torch.matmul(al, bh)))


def _mm_bf16(a, b):
    """ONE bf16 product with float32 accumulation: bf16 input rounding
    (~2^-8 relative).  Lossy: races only under a widened gate or a
    forced impl."""
    import torch
    return torch.matmul(_bf16(a.float()), _bf16(b.float()))
