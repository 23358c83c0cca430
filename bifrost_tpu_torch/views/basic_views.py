"""Header-only stream transforms, with no data movement (reference:
python/bifrost/views/basic_views.py:39-215; the port of
``bifrost_tpu/views/basic_views.py``).

Each view wraps a block's output ring with a header transform
(:func:`bifrost_tpu_torch.pipeline.block_view`); the data bytes are
untouched.  Tensor metadata convention: ``_tensor`` dict with
``shape`` (-1 marks the frame/time axis), ``dtype``, ``labels``,
``scales`` [(offset, step)], ``units``.
"""

from __future__ import annotations

import numpy as np

from ..pipeline import block_view
from ..dtype import DataType
from ..units import convert_units

__all__ = ['custom', 'rename_axis', 'reinterpret_axis', 'reverse_scale',
           'add_axis', 'delete_axis', 'astype', 'split_axis', 'merge_axes',
           'expose_view']


def custom(block, hdr_transform):
    """Alias of pipeline.block_view."""
    return block_view(block, hdr_transform)


def rename_axis(block, old, new):
    def header_transform(hdr):
        axis = hdr['_tensor']['labels'].index(old)
        hdr['_tensor']['labels'][axis] = new
        return hdr
    return block_view(block, header_transform)


def reinterpret_axis(block, axis, label=None, scale=None, units=None):
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax = tensor['labels'].index(axis) if isinstance(axis, str) else axis
        if label is not None:
            tensor['labels'][ax] = label
        if scale is not None:
            tensor['scales'][ax] = scale
        if units is not None:
            tensor['units'][ax] = units
        return hdr
    return block_view(block, header_transform)


def reverse_scale(block, axis):
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax = tensor['labels'].index(axis) if isinstance(axis, str) else axis
        tensor['scales'][ax][1] *= -1
        return hdr
    return block_view(block, header_transform)


def add_axis(block, axis, label=None, scale=None, units=None):
    """Insert a length-1 axis at ``axis`` (after the named axis if a
    string)."""
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax = axis
        if isinstance(ax, str):
            ax = tensor['labels'].index(ax) + 1
        if ax < 0:
            ax += len(tensor['shape']) + 1
        tensor['shape'].insert(ax, 1)
        for key, val in (('labels', label), ('scales', scale),
                         ('units', units)):
            if key in tensor:
                tensor[key].insert(ax, val)
        return hdr
    return block_view(block, header_transform)


def delete_axis(block, axis):
    """Remove a length-1 axis."""
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax = tensor['labels'].index(axis) if isinstance(axis, str) else axis
        if ax < 0:
            ax += len(tensor['shape']) + 1
        if tensor['shape'][ax] != 1:
            raise ValueError("Cannot delete non-unitary axis %r "
                             "(length %d)" % (axis, tensor['shape'][ax]))
        for key in ('shape', 'labels', 'scales', 'units'):
            if key in tensor:
                del tensor[key][ax]
        return hdr
    return block_view(block, header_transform)


def astype(block, dtype):
    """Reinterpret the last axis as a different dtype (bit-cast)."""
    def header_transform(hdr):
        tensor = hdr['_tensor']
        old_bits = DataType(tensor['dtype']).itemsize_bits
        new_bits = DataType(dtype).itemsize_bits
        axis_bits = old_bits * tensor['shape'][-1]
        if axis_bits % new_bits:
            raise ValueError("New type not compatible with data shape")
        tensor['shape'][-1] = axis_bits // new_bits
        tensor['dtype'] = str(DataType(dtype))
        return hdr
    return block_view(block, header_transform)


def split_axis(block, axis, n, label=None):
    """Split ``axis`` into (axis, n).  Splitting the frame axis reshapes
    time: gulp_nframe shrinks by n."""
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax = tensor['labels'].index(axis) if isinstance(axis, str) else axis
        shape = tensor['shape']
        if shape[ax] == -1:
            hdr['gulp_nframe'] = (hdr['gulp_nframe'] - 1) // n + 1
        else:
            if shape[ax] % n:
                raise ValueError("Split does not evenly divide axis "
                                 "(%d // %d)" % (shape[ax], n))
            shape[ax] //= n
        shape.insert(ax + 1, n)
        if 'units' in tensor:
            tensor['units'].insert(ax + 1, tensor['units'][ax])
        if 'labels' in tensor:
            new_label = label if label is not None \
                else tensor['labels'][ax] + '_split'
            tensor['labels'].insert(ax + 1, new_label)
        if 'scales' in tensor:
            tensor['scales'].insert(ax + 1, [0, tensor['scales'][ax][1]])
            tensor['scales'][ax][1] *= n
        return hdr
    return block_view(block, header_transform)


def merge_axes(block, axis1, axis2, label=None):
    """Merge two adjacent axes; merging onto the frame axis reshapes time:
    gulp_nframe grows by the length of the second axis."""
    def header_transform(hdr):
        tensor = hdr['_tensor']
        ax1 = tensor['labels'].index(axis1) if isinstance(axis1, str) \
            else axis1
        ax2 = tensor['labels'].index(axis2) if isinstance(axis2, str) \
            else axis2
        ax1, ax2 = sorted([ax1, ax2])
        if ax2 != ax1 + 1:
            raise ValueError("Merge axes must be adjacent")
        n = tensor['shape'][ax2]
        if n == -1:
            raise ValueError("Second merge axis cannot be the frame axis")
        if tensor['shape'][ax1] == -1:
            hdr['gulp_nframe'] *= n
        else:
            tensor['shape'][ax1] *= n
        del tensor['shape'][ax2]
        if 'scales' in tensor and 'units' in tensor:
            scale1 = tensor['scales'][ax1][1]
            scale2 = tensor['scales'][ax2][1]
            scale2 = convert_units(scale2, tensor['units'][ax2],
                                   tensor['units'][ax1])
            if not np.isclose(scale1, n * scale2):
                raise ValueError("Scales of merge axes do not line up: "
                                 "%s != %s" % (scale1, n * scale2))
            tensor['scales'][ax1][1] = scale2
            del tensor['scales'][ax2]
            del tensor['units'][ax2]
        if 'labels' in tensor:
            if label is not None:
                tensor['labels'][ax1] = label
            del tensor['labels'][ax2]
        return hdr
    return block_view(block, header_transform)


def expose_view(block):
    """Identity view (useful for testing header plumbing)."""
    return block_view(block, lambda hdr: hdr)
