"""Axis reductions by a factor (reference: src/reduce.cu:898-920; JAX
package: ``bifrost_tpu/ops/reduce.py:_reduce_jax``).  The port carries
the sum, the op the spectrometer chain uses; the other ops of the JAX
package are not ported yet."""

from __future__ import annotations

__all__ = ['_reduce_torch']


def _reduce_torch(x, axis, factor, op='sum'):
    """Sum ``axis`` of tensor ``x`` in groups of ``factor`` adjacent
    elements (the whole axis when ``factor`` is None)."""
    if op != 'sum':
        raise NotImplementedError("reduce op %r is not ported" % (op,))
    n = x.shape[axis]
    if factor is None:
        factor = n
    if n % factor:
        raise ValueError("Reduce factor %d does not divide axis length %d"
                         % (factor, n))
    x = x.reshape(x.shape[:axis] + (n // factor, factor) +
                  x.shape[axis + 1:])
    return x.sum(dim=axis + 1)
