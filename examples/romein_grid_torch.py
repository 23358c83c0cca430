"""Streaming Romein gridder demo through the PyTorch/CUDA port,
bifrost_tpu_torch (the port of examples/romein_grid.py): grid a stream of
visibility snapshots onto a common uv-grid with ``ops.romein.Romein`` (a
scatter-add of each point's kernel onto the grid on the card), then image
the accumulated grid with a 2-D FFT and report the recovered point
source.

  snapshot visibilities (time, npts) -> copy('cuda')
    -> RomeinGridder (per-frame ksize x ksize kernel scatter)
    -> copy('system') -> grid accumulator + dirty image

It runs on the first CUDA device (cuda:0); a caller that wants the CPU
calls bifrost_tpu_torch.device.set_device('cpu') before run().

Run: python examples/romein_grid_torch.py
"""

import os
import sys
from copy import deepcopy

import numpy as np

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import bifrost_tpu_torch as bt
from bifrost_tpu_torch.ops.romein import Romein

NPTS, NGRID, KSIZE = 64, 32, 3
NTIME, GULP = 32, 8
SRC_LM = (5, -3)          # point-source offset in image pixels


def make_baselines():
    """Static uv tracks: npts baseline coords on the grid plus a
    ksize x ksize separable triangle (linear-interp) kernel each."""
    rng = np.random.RandomState(7)
    uv = rng.randint(0, NGRID, size=(NPTS, 2)).astype(np.int32)
    tri = np.array([0.5, 1.0, 0.5])
    kern = np.broadcast_to((tri[:, None] * tri[None, :]),
                           (NPTS, KSIZE, KSIZE))
    return uv, kern.astype(np.complex64)


UV, KERNELS = make_baselines()


class SnapshotSource(bt.SourceBlock):
    """One visibility snapshot per frame: the npts baselines sampling
    a unit point source at image offset SRC_LM (a pure fringe)."""

    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        l, m = SRC_LM
        # kernel-center coords: init positions are the kernel ORIGIN
        u = UV[:, 0] + KSIZE // 2
        v = UV[:, 1] + KSIZE // 2
        fringe = np.exp(2j * np.pi * (u * l + v * m) / NGRID)
        self.vis = fringe.astype(np.complex64)
        self.pos = 0
        return [{'name': 'snapshots',
                 '_tensor': {'shape': [-1, NPTS], 'dtype': 'cf32',
                             'labels': ['time', 'baseline'],
                             'scales': [[0.0, 1.0], [0, 1]],
                             'units': ['s', None]}}]

    def on_data(self, reader, ospans):
        if self.pos >= NTIME:
            return [0]
        n = min(ospans[0].nframe, NTIME - self.pos)
        ospans[0].data.as_numpy()[:n] = self.vis[None, :]
        self.pos += n
        return [n]


class RomeinGridder(bt.TransformBlock):
    """Scatters each frame's npts visibilities through its gridding
    kernel onto a fresh (ngrid, ngrid) plane (grid accumulation across
    frames happens in the sink, keeping the block stateless)."""

    def __init__(self, iring, **kwargs):
        super(RomeinGridder, self).__init__(iring, **kwargs)
        self.engine = Romein().init(UV, KERNELS, NGRID)

    def define_valid_input_spaces(self):
        return ('cuda',)

    def on_sequence(self, iseq):
        ohdr = deepcopy(iseq.header)
        t = ohdr['_tensor']
        t['shape'] = [-1, NGRID, NGRID]
        t['labels'] = ['time', 'v', 'u']
        t['scales'] = [t['scales'][0], [0, 1], [0, 1]]
        t['units'] = [t['units'][0], None, None]
        return ohdr

    def on_data(self, ispan, ospan):
        ospan.set(self.engine.execute(ispan.data))


class DirtyImager(bt.SinkBlock):
    def __init__(self, iring, **kwargs):
        super(DirtyImager, self).__init__(iring, **kwargs)
        self.grid = np.zeros((NGRID, NGRID), np.complex64)
        self.nsnap = 0

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        planes = ispan.data.as_numpy()
        self.grid += planes.sum(axis=0)
        self.nsnap += planes.shape[0]

    def image(self):
        return np.fft.fft2(self.grid).real / max(self.nsnap, 1)


def build():
    """The gridding pipeline: (pipeline, imager)."""
    with bt.Pipeline() as pipeline:
        src = SnapshotSource(['snapshots'], gulp_nframe=GULP)
        b = bt.blocks.copy(src, space='cuda')
        b = RomeinGridder(b)
        b = bt.blocks.copy(b, space='system')
        imager = DirtyImager(b)
    return pipeline, imager


def run():
    """Build and run the gridding pipeline; returns the imager."""
    pipeline, imager = build()
    pipeline.run()
    return imager


def peak_lm(img):
    """(l, m) pixel offset of the dirty image's peak."""
    m, l = np.unravel_index(np.argmax(img), img.shape)
    l = l - NGRID if l >= NGRID // 2 else l
    m = m - NGRID if m >= NGRID // 2 else m
    return int(l), int(m)


def main():
    imager = run()
    l, m = peak_lm(imager.image())
    print('gridded %d snapshots x %d baselines; dirty-image peak at '
          '(l=%d, m=%d), true (l=%d, m=%d)'
          % (imager.nsnap, NPTS, l, m, SRC_LM[0], SRC_LM[1]))


if __name__ == '__main__':
    main()
