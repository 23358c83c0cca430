"""Visibility-matrix reordering/conversion block (the port of
``bifrost_tpu/blocks/convert_visibilities.py``; reference:
python/bifrost/blocks/convert_visibilities.py:36-209).

Formats:
- 'matrix'  : ['time','freq','station_i','pol_i','station_j','pol_j'],
              Hermitian; may be lower-triangle-filled
- 'storage' : ['time','baseline','freq','stokes'] — packed lower
              triangle with Stokes (I,Q,U,V) products per baseline

The conversions are torch gathers and scatters on the device.
Matrix -> storage gathers the lower triangle straight from the input and
takes a diagonal baseline's (x, y) product from the conjugate of its
(y, x) product: the values of the JAX package's conversion, which first
fills the whole Hermitian matrix, without the two matrix-sized
temporaries that costs (2.1 GB each a gulp at the FX correlator's
256 stations x 1024 channels).
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from ..pipeline import TransformBlock

__all__ = ['ConvertVisibilitiesBlock', 'convert_visibilities']


def _tri_indices(nstand):
    """(station_i, station_j) of each baseline, i >= j, in storage order."""
    b_i, b_j = [], []
    for i in range(nstand):
        for j in range(i + 1):
            b_i.append(i)
            b_j.append(j)
    return np.asarray(b_i), np.asarray(b_j)


def baseline_indices(nstand, device):
    """(bi, bj, diag): int64 tensors on ``device`` of each baseline's
    stations and of the autocorrelation baselines' positions."""
    import torch
    b_i, b_j = _tri_indices(nstand)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (b_i, b_j, np.flatnonzero(b_i == b_j)))


def _lower_mask(nstand, npol, device):
    """(S, P, S, P) bool: True where the lower-filled matrix holds the
    product (i > j, or i == j and pi >= pj)."""
    import torch
    ii = torch.arange(nstand, device=device)
    pi = torch.arange(npol, device=device)
    return (ii[:, None, None, None] > ii[None, None, :, None]) | \
        ((ii[:, None, None, None] == ii[None, None, :, None]) &
         (pi[None, :, None, None] >= pi[None, None, None, :]))


def _fill_hermitian(x):
    """The full Hermitian matrix of a lower-filled (t, f, S, P, S, P)
    one: the upper triangle from the conjugate transpose."""
    import torch
    cond = _lower_mask(x.shape[2], x.shape[3], x.device)
    sw = torch.conj(x.permute(0, 1, 4, 5, 2, 3))
    return torch.where(cond, x, sw)


def matrix_to_storage(x, bi, bj, diag):
    """(t, f, S, 2, S, 2) lower-filled visibilities -> (t, nbl, f, 4)
    Stokes I, Q, U, V of each baseline (``bi``, ``bj``, ``diag`` from
    :func:`baseline_indices`)."""
    import torch
    # advanced indices split by a slice: the baseline axis comes first
    v = x[:, :, bi, :, bj, :]                      # (nbl, t, f, 2, 2)
    # an autocorrelation's (x, y) product is the conjugate of its (y, x)
    v[diag, ..., 0, 1] = torch.conj(v[diag, ..., 1, 0])
    xx, xy = v[..., 0, 0], v[..., 0, 1]
    yx, yy = v[..., 1, 0], v[..., 1, 1]
    nbl, t, f = v.shape[:3]
    out = torch.empty((t, nbl, f, 4), dtype=torch.complex64, device=x.device)
    for k, s in enumerate((xx + yy, xx - yy, xy + yx, (xy - yx) * 1j)):
        out[..., k] = s.movedim(0, 1)
    return out


def storage_to_matrix(x, bi, bj, nstand):
    """(t, nbl, f, 4) Stokes -> the full Hermitian (t, f, S, 2, S, 2)
    matrix."""
    import torch
    I, Q, U, V = (x[..., k] for k in range(4))
    xx = 0.5 * (I + Q)
    yy = 0.5 * (I - Q)
    xy = 0.5 * (U - 1j * V)
    yx = 0.5 * (U + 1j * V)
    blk = torch.stack([torch.stack([xx, xy], -1),
                       torch.stack([yx, yy], -1)], -2)   # (t, nbl, f, 2, 2)
    t, nbl, f = x.shape[:3]
    out = torch.zeros((t, f, nstand, 2, nstand, 2), dtype=torch.complex64,
                      device=x.device)
    out[:, :, bi, :, bj, :] = blk.movedim(1, 0).to(torch.complex64)
    return _fill_hermitian(out)


class ConvertVisibilitiesBlock(TransformBlock):
    def __init__(self, iring, ofmt, *args, **kwargs):
        super(ConvertVisibilitiesBlock, self).__init__(iring, *args,
                                                       **kwargs)
        self.ofmt = ofmt
        self._fn = None
        self._fn_key = None

    def define_valid_input_spaces(self):
        return ('cuda',)

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr['_tensor']
        labels = itensor['labels']
        if labels[:2] == ['time', 'freq'] and 'station_i' in labels[2]:
            self.ifmt = 'matrix'
        elif labels[:2] == ['time', 'baseline']:
            self.ifmt = 'storage'
        else:
            raise ValueError("Unrecognized visibility layout: %s" % labels)
        ohdr = deepcopy(ihdr)
        otensor = ohdr['_tensor']
        if self.ifmt == 'matrix' and self.ofmt == 'matrix':
            ohdr['matrix_fill_mode'] = 'full'
        elif self.ifmt == 'matrix' and self.ofmt == 'storage':
            t, f = itensor['shape'][0], itensor['shape'][1]
            nstand = itensor['shape'][2]
            nbl = nstand * (nstand + 1) // 2
            otensor['shape'] = [t, nbl, f, 4]
            otensor['labels'] = ['time', 'baseline', 'freq', 'stokes']
            otensor['scales'] = [deepcopy(itensor['scales'][0]), None,
                                 deepcopy(itensor['scales'][1]), None]
            otensor['units'] = [itensor['units'][0], None,
                                itensor['units'][1], None]
            self.nstand = nstand
        elif self.ifmt == 'storage' and self.ofmt == 'matrix':
            t, nbl, f = itensor['shape'][:3]
            nstand = int((np.sqrt(8 * nbl + 1) - 1) / 2)
            otensor['shape'] = [t, f, nstand, 2, nstand, 2]
            otensor['labels'] = ['time', 'freq', 'station_i', 'pol_i',
                                 'station_j', 'pol_j']
            otensor['scales'] = [deepcopy(itensor['scales'][0]),
                                 deepcopy(itensor['scales'][2]),
                                 None, None, None, None]
            otensor['units'] = [itensor['units'][0], itensor['units'][2],
                                None, None, None, None]
            ohdr['matrix_fill_mode'] = 'full'
            self.nstand = nstand
        else:
            raise ValueError("Unsupported conversion %s -> %s"
                             % (self.ifmt, self.ofmt))
        self._fn_key = None
        return ohdr

    def _build(self, x):
        ifmt, ofmt = self.ifmt, self.ofmt
        if ifmt == 'matrix' and ofmt == 'matrix':
            return _fill_hermitian
        bi, bj, diag = baseline_indices(self.nstand, x.device)
        if ifmt == 'matrix' and ofmt == 'storage':
            return lambda v: matrix_to_storage(v, bi, bj, diag)
        if ifmt == 'storage' and ofmt == 'matrix':
            nstand = self.nstand
            return lambda v: storage_to_matrix(v, bi, bj, nstand)
        raise ValueError((ifmt, ofmt))

    def on_data(self, ispan, ospan):
        x = ispan.data
        key = (tuple(x.shape), x.device)
        if self._fn_key != key:
            self._fn = self._build(x)
            self._fn_key = key
        ospan.set(self._fn(x))


def convert_visibilities(iring, fmt, *args, **kwargs):
    """Block: reorder/convert visibility data between 'matrix' and
    'storage' formats (reference docstring:
    blocks/convert_visibilities.py:169-209)."""
    return ConvertVisibilitiesBlock(iring, fmt, *args, **kwargs)
