"""Axis reductions by a factor (reference: src/reduce.cu:898-920,
python/bifrost/reduce.py, src/bifrost/reduce.h:45-54; the port of
``bifrost_tpu/ops/reduce.py:23-89``).

ops: sum / mean / min / max / stderr, and the power variants
(pwrsum / pwrmean / ...) that square-detect their input first.  A
``factor`` reduces an axis by that factor (reshape trick); no factor
collapses the whole axis.
"""

from __future__ import annotations

import numpy as np

from .common import as_logical, logical_dtype, writeback

__all__ = ['reduce', '_reduce_torch']

_OPS = ('sum', 'mean', 'min', 'max', 'stderr',
        'pwrsum', 'pwrmean', 'pwrmin', 'pwrmax', 'pwrstderr')


def _reduce_torch(x, axis, factor, op='sum'):
    """Reduce ``axis`` of tensor ``x`` in groups of ``factor`` adjacent
    elements (the whole axis when ``factor`` is None) with ``op``.
    Integer inputs are summed as int64 and averaged in float32, as
    ``jnp`` promotes them."""
    import torch
    if op not in _OPS:
        raise ValueError("Unknown reduce op %r" % op)
    power = op.startswith('pwr')
    base = op[3:] if power else op
    if power:
        x = x.real * x.real + x.imag * x.imag if x.is_complex() \
            else x * x
    n = x.shape[axis]
    if factor is None:
        factor = n
    if n % factor:
        raise ValueError("Reduce factor %d does not divide axis length %d"
                         % (factor, n))
    x = x.reshape(x.shape[:axis] + (n // factor, factor) +
                  x.shape[axis + 1:])
    rax = axis + 1
    if base == 'sum':
        return x.sum(dim=rax)
    if base == 'min':
        return x.amin(dim=rax)
    if base == 'max':
        return x.amax(dim=rax)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if base == 'mean':
        return x.mean(dim=rax)
    # the standard error of the mean (reference: reduce.h stderr op)
    return x.std(dim=rax, correction=0) / np.sqrt(factor)


def reduce(idata, odata, op='sum'):
    """Reduce ``idata`` into ``odata``; the reduced axis and factor are
    inferred from the shapes (reference: python/bifrost/reduce.py)."""
    x = as_logical(idata)
    ishape = tuple(idata.shape)
    oshape = tuple(odata.shape)
    if len(ishape) != len(oshape):
        raise ValueError("reduce requires equal ranks (use views to "
                         "relabel axes): %s vs %s" % (ishape, oshape))
    axes = [i for i, (a, b) in enumerate(zip(ishape, oshape)) if a != b]
    if len(axes) > 1:
        raise ValueError("reduce supports exactly one reduced axis; "
                         "shapes %s vs %s" % (ishape, oshape))
    axis = axes[0] if axes else 0
    if ishape[axis] % oshape[axis]:
        raise ValueError("Output axis %d length %d does not divide "
                         "input length %d"
                         % (axis, oshape[axis], ishape[axis]))
    y = _reduce_torch(x, axis, ishape[axis] // oshape[axis], op)
    odt = logical_dtype(odata).as_floating_point()
    if y.is_complex() and odt.is_real:
        y = y.real
    return writeback(y.to(odt.as_torch_dtype()), odata)
