"""Romein-style convolutional gridding (the port of
``bifrost_tpu/ops/romein.py``; reference: src/romein.cu:74-637, the
per-visibility scatter of a ksize x ksize kernel onto a 2-D grid;
python/bifrost/romein.py).

Each point's ksize x ksize products ``data * kernel`` are added onto the
grid at its position's window, which wraps modulo ``ngrid``.  The port
scatters them with one ``index_add_`` on ``torch.view_as_real`` of the
grid, flattened over the batch and both grid axes (CUDA atomics on the
card, as the reference's per-thread scatter adds with atomics).  The order
of the atomic adds varies from run to run, so results agree with an
oracle to rounding, not bit for bit.
"""

from __future__ import annotations

from .common import as_tensor, writeback

__all__ = ['Romein']


class Romein(object):
    def __init__(self):
        self._positions = None
        self._kernels = None
        self._ngrid = None

    def init(self, positions, kernels, ngrid, polmajor=True):
        """positions: (..., npts, 2) int grid coords of each point's
        kernel origin (x, y); kernels: (..., npts, ksize, ksize) complex;
        ngrid: output grid side length.  ``polmajor=False`` raises: the
        JAX package stores it and grids as if it were True."""
        if not polmajor:
            raise NotImplementedError(
                "Romein: polmajor=False is not supported (the JAX package "
                "ignores it and grids pol-major)")
        self._positions = as_tensor(positions)
        self._kernels = as_tensor(kernels)
        self._ngrid = int(ngrid)
        return self

    def set_positions(self, positions):
        self._positions = as_tensor(positions)
        return self

    def set_kernels(self, kernels):
        self._kernels = as_tensor(kernels)
        return self

    def execute(self, idata, odata=None, accumulate=False):
        """idata: (..., npts) values -> grid (..., ngrid, ngrid) complex.
        With ``accumulate`` the products add onto ``odata``'s grid (a
        tensor is updated in place); otherwise onto zeros."""
        import torch
        x = as_tensor(idata)
        dev = x.device
        ngrid = self._ngrid
        batch = tuple(x.shape[:-1])
        npts = x.shape[-1]
        cdt = torch.complex128 if x.dtype == torch.complex128 \
            else torch.complex64
        pos = self._positions.to(dev).to(torch.int64)
        kern = self._kernels.to(dev)
        k = kern.shape[-1]
        if odata is not None and accumulate:
            in_place = isinstance(odata, torch.Tensor) and \
                odata.device == dev and odata.is_contiguous()
            grid = odata if in_place else \
                as_tensor(odata).to(dev).contiguous().clone()
        else:
            grid = torch.zeros(batch + (ngrid, ngrid), dtype=cdt, device=dev)
        nb = 1
        for b in batch:
            nb *= b
        fp = pos.expand(batch + tuple(pos.shape[-2:])).reshape(nb, npts, 2)
        fk = kern.expand(batch + tuple(kern.shape[-3:])) \
            .reshape(nb, npts, k, k)
        d = torch.arange(k, device=dev)
        gx = torch.remainder(fp[..., 0, None, None] + d[None, None, :], ngrid)
        gy = torch.remainder(fp[..., 1, None, None] + d[None, :, None], ngrid)
        base = torch.arange(nb, device=dev).reshape(nb, 1, 1, 1) * \
            (ngrid * ngrid)
        idx = (base + gy * ngrid + gx).reshape(-1)
        contrib = (x.reshape(nb, npts)[..., None, None] * fk).to(grid.dtype)
        flat = torch.view_as_real(grid.view(-1))
        flat.index_add_(0, idx, torch.view_as_real(contrib.reshape(-1)))
        if odata is not None and grid is not odata:
            return writeback(grid, odata)
        return grid
