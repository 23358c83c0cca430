"""Writing your first block, through the PyTorch/CUDA port
(bifrost_tpu_torch): examples/your_first_block.py, block for block
(reference: testbench/your_first_block.py).

A TransformBlock needs two methods:
- on_sequence(iseq): inspect/transform the header, return the output
  header
- on_data(ispan, ospan): compute one gulp

Device blocks receive torch tensors from 'cuda'-space rings and publish
results with ospan.set(...); host blocks write numpy views in place.
The chain runs on the first CUDA device (cuda:0); a caller that wants
the CPU calls bifrost_tpu_torch.device.set_device('cpu') first.

Run: python your_first_block_torch.py
"""

import os
import sys

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from copy import deepcopy

import bifrost_tpu_torch as bt


class UselessAdd(bt.TransformBlock):
    """Adds 1000 to every sample, on the card when the ring is there."""

    def on_sequence(self, iseq):
        return deepcopy(iseq.header)

    def on_data(self, ispan, ospan):
        if ispan.ring.space == 'cuda':
            ospan.set(ispan.data + 1000.0)
        else:
            ospan.data.as_numpy()[...] = \
                ispan.data.as_numpy() + 1000.0


class PrintStats(bt.SinkBlock):
    def __init__(self, iring, quiet=False, **kwargs):
        super(PrintStats, self).__init__(iring, **kwargs)
        self.quiet = quiet
        self.means = []

    def on_sequence(self, iseq):
        if not self.quiet:
            print("sequence:", iseq.header['name'])

    def on_data(self, ispan):
        d = ispan.data.as_numpy()
        self.means.append(float(d.mean()))
        if not self.quiet:
            print("gulp mean = %.2f" % self.means[-1])


class CountingSource(bt.SourceBlock):
    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        self.count = 0
        return [{'name': name,
                 '_tensor': {'shape': [-1, 16], 'dtype': 'f32',
                             'labels': ['time', 'chan'],
                             'scales': [[0, 1], [0, 1]],
                             'units': [None, None]}}]

    def on_data(self, reader, ospans):
        if self.count >= 4:
            return [0]
        self.count += 1
        ospans[0].data.as_numpy()[...] = self.count
        return [ospans[0].nframe]


def build(quiet=False):
    """The chain, built and not run: (pipeline, stats sink)."""
    with bt.Pipeline() as pipeline:
        src = CountingSource(['demo'], gulp_nframe=8)
        b = bt.blocks.copy(src, space='cuda')
        b = UselessAdd(b)
        b = bt.blocks.copy(b, space='system')
        stats = PrintStats(b, quiet=quiet)
    return pipeline, stats


def main():
    pipeline, _stats = build()
    pipeline.run()


if __name__ == '__main__':
    main()
