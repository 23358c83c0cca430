"""Axis-reduction block, frame-axis factors included (reference:
python/bifrost/blocks/reduce.py:39-126; the port of
``bifrost_tpu/blocks/reduce.py``).  On a ``cuda`` ring the math is
:class:`bifrost_tpu_torch.stages.ReduceStage`; a ``system`` ring takes
the numpy path below, as the JAX block's does."""

from __future__ import annotations

import numpy as np

from ..stages import ReduceStage
from .fft import _StageBlock

__all__ = ['ReduceBlock', 'reduce']


class ReduceBlock(_StageBlock):
    def __init__(self, iring, axis, factor=None, op='sum', *args, **kwargs):
        super(ReduceBlock, self).__init__(
            iring, ReduceStage(axis, factor, op), *args, **kwargs)

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(ReduceBlock, self).on_data(ispan, ospan)
        st = self._stage
        x = ispan.data.as_numpy()
        axis = st.axis
        f = st.factor if st.factor is not None else x.shape[axis]
        n = x.shape[axis]
        xr = x.reshape(x.shape[:axis] + (n // f, f) + x.shape[axis + 1:])
        op = st.op
        if op.startswith('pwr'):
            xr = np.abs(xr.astype(np.complex64)) ** 2 \
                if np.iscomplexobj(xr) else xr.astype(np.float32) ** 2
            op = op[3:]
        out = ospan.data.as_numpy()
        res = _host_reduce(xr, axis + 1, f, op)
        out[...] = res.real.astype(out.dtype) \
            if np.iscomplexobj(res) and out.dtype.kind != 'c' \
            else res.astype(out.dtype)


def _host_reduce(xr, rax, f, op):
    """Reduce the inserted factor axis ``rax`` of ``xr``.

    np.sum over a small trailing axis is slow (pairwise, no SIMD across
    the stride); a matrix-vector product with a ones vector does the same
    contraction at memory speed.  Float sum/mean take it up to f = 512
    (beyond that np.sum's pairwise sum is the more accurate) and min/max
    a strided running comparison up to f = 64; larger factors, stderr and
    integers keep the numpy reductions (``bifrost_tpu/blocks/
    reduce.py:54-80``)."""
    if op in ('sum', 'mean') and xr.dtype.kind in 'fc' and f <= 512:
        res = np.moveaxis(xr, rax, -1) @ np.ones(f, dtype=xr.dtype)
        if op == 'mean':
            res = res / f
        return res
    if op in ('min', 'max') and f <= 64:
        sl = [slice(None)] * xr.ndim
        sl[rax] = 0
        acc = np.array(xr[tuple(sl)])
        best = np.minimum if op == 'min' else np.maximum
        for j in range(1, f):
            sl[rax] = j
            best(acc, xr[tuple(sl)], out=acc)
        return acc
    fn = {'sum': np.sum, 'mean': np.mean, 'min': np.min, 'max': np.max,
          'stderr': lambda a, axis: np.std(a, axis=axis) / np.sqrt(f)
          }[op]
    return fn(xr, axis=rax)


def reduce(iring, axis, factor=None, op='sum', *args, **kwargs):
    """Block: reduce along an axis by ``factor`` using ``op`` (sum, mean,
    min, max, stderr, pwr* variants; reference docstring:
    blocks/reduce.py:92-126)."""
    return ReduceBlock(iring, axis, factor, op, *args, **kwargs)
