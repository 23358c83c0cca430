"""Checkpoint and replay through the PyTorch/CUDA port
(bifrost_tpu_torch): examples/serialize_replay.py, step for step
(reference: blocks/serialize.py:45-100 and the disk-replay capture
path).  Record a processed stream to the ``.bf.json`` + ``.bf.*.dat``
serialize format, then replay it through a second pipeline and check
that the replayed output is bit-identical.

  live:   [synth pulse train] -> copy('cuda') -> detect -> copy('system')
          -> serialize    (-> disk)
  replay: deserialize -> [gather + verify bit-identical]

The live chain runs on the first CUDA device (cuda:0); a caller that
wants the CPU calls bifrost_tpu_torch.device.set_device('cpu') first.

Run: python serialize_replay_torch.py [workdir]
"""

import os
import sys
import tempfile

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np

import bifrost_tpu_torch as bt

NTIME, NCHAN, PERIOD = 128, 64, 25


class PulseTrain(bt.SourceBlock):
    """cf32 stream with a pulse every PERIOD frames."""

    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        rng = np.random.RandomState(2)
        x = (rng.randn(NTIME, NCHAN) +
             1j * rng.randn(NTIME, NCHAN)).astype(np.complex64)
        x[::PERIOD] *= 8.0
        self.data = x
        self.pos = 0
        return [{'name': 'pulses',
                 '_tensor': {'shape': [-1, NCHAN], 'dtype': 'cf32',
                             'labels': ['time', 'freq'],
                             'scales': [[0.0, 1e-3], [1400.0, -0.1]],
                             'units': ['s', 'MHz']}}]

    def on_data(self, reader, ospans):
        if self.pos >= NTIME:
            return [0]
        n = min(ospans[0].nframe, NTIME - self.pos)
        ospans[0].data.as_numpy()[:n] = self.data[self.pos:self.pos + n]
        self.pos += n
        return [n]


class Gather(bt.SinkBlock):
    def __init__(self, iring, **kwargs):
        super(Gather, self).__init__(iring, **kwargs)
        self.chunks = []
        self.header = None

    def on_sequence(self, iseq):
        self.header = iseq.header

    def on_data(self, ispan):
        self.chunks.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self):
        return np.concatenate(self.chunks, axis=0)


def build_live(workdir):
    """synth -> detect on the card -> record: (pipeline, live sink)."""
    with bt.Pipeline() as p:
        src = PulseTrain(['pulses'], gulp_nframe=16)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.detect(b, mode='scalar')
        b = bt.blocks.copy(b, space='system')
        live = Gather(b)                       # what science saw live
        bt.blocks.serialize(b, path=workdir)   # ... and the recording
    return p, live


def build_replay(base):
    """Resume from disk alone: (pipeline, replay sink)."""
    with bt.Pipeline() as p:
        b = bt.blocks.deserialize([base], gulp_nframe=16)
        replay = Gather(b)
    return p, replay


def main(workdir, run=lambda p: p.run()):
    os.makedirs(workdir, exist_ok=True)
    p, live = build_live(workdir)
    run(p)
    base = os.path.join(workdir, 'pulses')
    assert os.path.exists(base + '.bf.json'), 'no serialized header'
    dats = [f for f in os.listdir(workdir) if f.endswith('.dat')]
    print('recorded %s.bf.json + %d data file(s)' % (base, len(dats)))

    p, replay = build_replay(base)
    run(p)
    a, b_ = live.result(), replay.result()
    assert a.shape == b_.shape, (a.shape, b_.shape)
    assert np.array_equal(a, b_), 'replay is not bit-identical'
    assert replay.header['_tensor']['labels'] == ['time', 'freq']
    pulses = int((b_.mean(axis=1) > 2 * np.median(b_)).sum())
    assert pulses == (NTIME + PERIOD - 1) // PERIOD, pulses
    print('replay bit-identical to live run; %d pulses at period %d'
          % (pulses, PERIOD))
    print('serialize_replay OK')
    return live, replay


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else
         tempfile.mkdtemp(prefix='bf_replay_'))
