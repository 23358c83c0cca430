"""File-format round trip through the PyTorch/CUDA port
(bifrost_tpu_torch): examples/file_roundtrip.py, hop for hop
(reference: testbench/test_file_read_write.py +
testbench/generate_test_data.py).  Synthesize a noise-plus-tone
time/pol stream, write raw binary, read it back, reduce on the card, and
write/read a SIGPROC filterbank, checking the bytes at each hop.

  [synth] -> binary_write              (.out raw file)
  binary_read -> copy('cuda') -> detect -> reduce -> copy('system')
              -> transpose -> write_sigproc    (.fil)
  read_sigproc -> [gather + verify]

The device hop runs on the first CUDA device (cuda:0); a caller that
wants the CPU calls bifrost_tpu_torch.device.set_device('cpu') first.

Run: python file_roundtrip_torch.py [workdir]
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

NTIME, NPOL, NCHAN, RF = 64, 2, 128, 4


def synth():
    """cf32 noise with a strong tone in channel 17 of pol 0."""
    rng = np.random.RandomState(1)
    x = (rng.randn(NTIME, NPOL, NCHAN) +
         1j * rng.randn(NTIME, NPOL, NCHAN)).astype(np.complex64)
    x[:, 0, 17] += 10.0
    return x


class SynthSource(bt.SourceBlock):
    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        self.data = synth()
        self.pos = 0
        return [{'name': 'synth',
                 '_tensor': {'shape': [-1, NPOL, NCHAN], 'dtype': 'cf32',
                             'labels': ['time', 'pol', 'freq'],
                             'scales': [[0.0, 1e-3], [0, 1],
                                        [1400.0, -0.1]],
                             'units': ['s', None, 'MHz']}}]

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

    def on_sequence(self, iseq):
        self.header = iseq.header

    def on_data(self, ispan):
        self.chunks.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self):
        return np.concatenate(self.chunks, axis=0)


def build_write_raw():
    """Hop 1: synth -> binary_write into the working directory."""
    with bt.Pipeline() as p:
        src = SynthSource(['synth'], gulp_nframe=16)
        bt.blocks.binary_write(src, file_ext='out')
    return p


def build_raw_to_fil(raw_path):
    """Hop 2: the raw file -> card detect/reduce -> SIGPROC filterbank."""
    with bt.Pipeline() as p:
        bc = bt.BlockChainer()
        # each frame is one (pol, chan) slice = NPOL*NCHAN cf32 samples
        bc.blocks.binary_read([raw_path], gulp_size=NPOL * NCHAN,
                              gulp_nframe=16, dtype='cf32')
        # binary_read yields flat 'sample' frames; reshape and relabel
        # to the original tensor layout
        bc.views.split_axis('sample', NCHAN, label='freq')
        bc.views.rename_axis('sample', 'pol')
        bc.blocks.copy(space='cuda')
        bc.blocks.detect(mode='stokes_i', axis='pol')
        bc.blocks.reduce('freq', RF)
        bc.blocks.copy(space='system')
        bc.blocks.transpose(['time', 'pol', 'freq'])
        bc.blocks.write_sigproc(path='.')
    return p


def build_read_fil(fil_path):
    """Hop 3: read the filterbank back: (pipeline, gather sink)."""
    with bt.Pipeline() as p:
        b = bt.blocks.read_sigproc([fil_path], gulp_nframe=16)
        sink = Gather(b)
    return p, sink


def main(workdir, run=lambda p: p.run()):
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)

    run(build_write_raw())
    raw_path = 'synth.out'
    assert os.path.exists(raw_path), 'binary_write produced no file'
    nbytes = os.path.getsize(raw_path)
    print('wrote %s (%d bytes)' % (raw_path, nbytes))
    assert nbytes == NTIME * NPOL * NCHAN * 8
    # bit fidelity, hop 1: the raw file is the synthesized stream
    want = synth()
    got = np.fromfile(raw_path, np.complex64).reshape(NTIME, NPOL, NCHAN)
    assert np.array_equal(got, want), 'binary file differs from synth'

    run(build_raw_to_fil(raw_path))
    fil = [f for f in os.listdir('.') if f.endswith('.fil')]
    assert fil, 'write_sigproc produced no .fil'
    print('wrote %s' % fil[0])

    p, sink = build_read_fil(fil[0])
    run(p)
    out = sink.result()
    # hop 2: the filterbank carries the card's Stokes-I reduced spectra
    # (f32 arithmetic against a numpy oracle)
    oracle = (np.abs(want) ** 2).sum(axis=1)            # I = |x|^2+|y|^2
    oracle = oracle.reshape(NTIME, NCHAN // RF, RF).sum(-1)
    flat = out.reshape(NTIME, -1)
    rel = np.max(np.abs(flat - oracle)) / np.max(np.abs(oracle))
    assert rel < 1e-5, 'filterbank payload differs from oracle (%g)' % rel
    spec = flat.mean(axis=0)
    peak = int(np.argmax(spec))
    print('tone detected in reduced channel %d (expect %d), '
          'payload rel err %.2e' % (peak, 17 // RF, rel))
    assert peak == 17 // RF
    print('file_roundtrip OK')
    return fil[0]


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else
         tempfile.mkdtemp(prefix='bf_roundtrip_'))
