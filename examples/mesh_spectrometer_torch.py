"""Spectrometer on a mesh, through the PyTorch/CUDA port
(bifrost_tpu_torch): examples/mesh_spectrometer.py, block for block.

Attach a mesh to a block scope and the blocks inside scale out: the H2D
copy places each gulp per rank (its frames split over the mesh's time
axis), and the fused FFT -> detect -> reduce chain runs as a frame-local
plan, one body per rank on its time shard, with no collective (see
bifrost_tpu_torch/parallel/scope.py).  The mesh here is four ranks on the
process's device, as the port's tests and chip_smoke.py run the mesh tier
on one card; on a machine with four cards, pass
``devices=['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3']``.

The chain runs on the first CUDA device (cuda:0); a caller that wants
the CPU calls bifrost_tpu_torch.device.set_device('cpu') first.

Run: python mesh_spectrometer_torch.py
"""

import os
import sys

import numpy as np

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import bifrost_tpu_torch as bt
from bifrost_tpu_torch.device import get_device
from bifrost_tpu_torch.parallel import create_mesh
from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage

#: ranks of the mesh, all on the process's device
NRANK = 4


class ToneSource(bt.SourceBlock):
    """Emits dual-pol complex gulps with a tone at bin 17."""

    NT, NP, NF = 64, 2, 256

    def __init__(self, ngulp=4, **kwargs):
        super(ToneSource, self).__init__(['tone'], self.NT,
                                         space='system', **kwargs)
        self.ngulp = ngulp
        self.count = 0
        t = np.arange(self.NF)
        tone = np.exp(2j * np.pi * 17 * t / self.NF)
        self.gulp = np.zeros((self.NT, self.NP, self.NF), np.complex64)
        self.gulp[:, 0] = tone
        self.gulp[:, 1] = 0.5 * tone

    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        self.count = 0
        return [{'name': 'tone', 'time_tag': 0,
                 '_tensor': {'shape': [-1, self.NP, self.NF],
                             'dtype': 'cf32',
                             'labels': ['time', 'pol', 'fine_time'],
                             'scales': [[0, 1]] * 3,
                             'units': [None] * 3}}]

    def on_data(self, reader, ospans):
        if self.count >= self.ngulp:
            return [0]
        self.count += 1
        ospans[0].data.as_numpy()[...] = self.gulp
        return [self.NT]


class PrintPeak(bt.SinkBlock):
    """Prints each gulp's Stokes-I peak and keeps the gulps."""

    def __init__(self, iring, **kwargs):
        super(PrintPeak, self).__init__(iring, **kwargs)
        self.gulps = []

    def on_sequence(self, iseq):
        print("sequence:", iseq.header['name'])

    def on_data(self, ispan):
        from bifrost_tpu_torch.xfer import to_host
        spec = to_host(ispan.data) if ispan.ring.is_device \
            else np.asarray(ispan.data.as_numpy())
        self.gulps.append(np.array(spec, copy=True))
        stokes_i = spec[0, 0]
        print("  Stokes-I peak at bin %d: %.1f"
              % (int(np.argmax(stokes_i)), float(stokes_i.max())))


def build(nrank=NRANK):
    """The mesh spectrometer: (pipeline, sink)."""
    mesh = create_mesh({'sp': nrank}, devices=[str(get_device())] * nrank)
    print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))
    with bt.Pipeline() as p:
        src = ToneSource()
        with bt.block_scope(mesh=mesh):
            # the H2D copy lives inside the mesh scope so gulps land per
            # rank; outside it, every gulp would land whole and the fused
            # block would pay a relayout a gulp (the verifier's BF-W140)
            b = bt.blocks.copy(src, space='cuda')
            b = bt.blocks.fused(b, [
                FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'),
                ReduceStage('freq', 4)])
        sink = PrintPeak(b)
    return p, sink


def main():
    p, _sink = build()
    p.run()


if __name__ == '__main__':
    main()
