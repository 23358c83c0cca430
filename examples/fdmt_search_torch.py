"""FDMT FRB search through the PyTorch/CUDA port (bifrost_tpu_torch):
examples/fdmt_search.py's single-host chain, block for block
(reference: testbench/test_fdmt.py).  Synthesize a dispersed pulse in a
filterbank stream, dedisperse with the stage-backed FDMT engine,
matched-filter across pulse widths, threshold, and report the detected
DM and time.

  dispersed filterbank -> copy('cuda') -> fdmt_stage  [DM transform]
    -> matched_filter (boxcar) -> threshold -> copy('system') -> peak

Every device block is stage-backed, so under ``BF_SEGMENTS=auto`` the
chain runs as one compiled segment with the halo carried inside it.
The chain runs on the first CUDA device (cuda:0); a caller that wants
the CPU calls bifrost_tpu_torch.device.set_device('cpu') first.

With ``--fabric`` the same chain is split over a two-host loopback
fabric (bifrost_tpu_torch.fabric): the 'capture' host streams the
filterbank over the 'filterbank' link into the 'search' host, which
dedisperses on the card; the peak equals the single-host run's.

Usage:
    python examples/fdmt_search_torch.py             # single host
    python examples/fdmt_search_torch.py --fabric    # two-host fabric
"""

import os
import socket
import sys
import threading

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np

import bifrost_tpu_torch as bt


def cff(f1, f2):
    """Quadratic dispersion delay factor between two frequencies."""
    return abs(f1 ** -2 - f2 ** -2)


NCHAN, NTIME, F0, DF = 64, 1024, 100.0, 1.0   # MHz
GULP = 256
MAX_DELAY = 64                                # DM trials (samples)
NTAP = 4                                      # boxcar matched filter
THRESH = 8.0                                  # ~5 sigma after the boxcar
D_TRUE, T0 = 40, 200                          # delay (samples), pulse time


class DispersedPulseSource(bt.SourceBlock):
    def __init__(self, **kwargs):
        super(DispersedPulseSource, self).__init__(
            ['pulse'], gulp_nframe=GULP, **kwargs)

    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        rng = np.random.RandomState(0)
        x = rng.randn(NCHAN, NTIME).astype(np.float32) * 0.1
        band = cff(F0, F0 + NCHAN * DF)
        for c in range(NCHAN):
            delay = D_TRUE * cff(F0, F0 + c * DF) / band
            x[c, T0 + int(round(delay))] += 3.0
        self.data = x
        self.pos = 0
        return [{'name': 'pulse',
                 '_tensor': {'shape': [NCHAN, -1], 'dtype': 'f32',
                             'labels': ['freq', 'time'],
                             'scales': [[F0, DF], [0.0, 1e-3]],
                             'units': ['MHz', 's']}}]

    def on_data(self, reader, ospans):
        if self.pos >= NTIME:
            return [0]
        n = min(ospans[0].nframe, NTIME - self.pos)
        ospans[0].data.as_numpy()[:, :n] = \
            self.data[:, self.pos:self.pos + n]
        self.pos += n
        return [n]


class PeakFinder(bt.SinkBlock):
    """Tracks the strongest above-threshold candidate in the (dm, time)
    stream; everything below THRESH arrives zeroed."""

    def __init__(self, iring, **kwargs):
        super(PeakFinder, self).__init__(iring, **kwargs)
        self.best = (-np.inf, 0, 0)
        self.ncandidates = 0
        self.offset = 0

    def on_sequence(self, iseq):
        self.dm_step = iseq.header['_tensor']['scales'][-2][1]

    def on_data(self, ispan):
        dmt = ispan.data.as_numpy()
        self.ncandidates += int(np.count_nonzero(dmt))
        row, t = np.unravel_index(np.argmax(dmt), dmt.shape)
        if dmt[row, t] > self.best[0]:
            self.best = (float(dmt[row, t]), int(row),
                         self.offset + int(t))
        self.offset += ispan.nframe


def build_search_chain(b):
    """The dedispersion chain on the card (every block stage-backed)."""
    b = bt.blocks.copy(b, space='cuda')
    b = bt.blocks.fdmt_stage(b, max_delay=MAX_DELAY)
    b = bt.blocks.matched_filter(b, NTAP)
    b = bt.blocks.threshold(b, THRESH)
    return bt.blocks.copy(b, space='system')


def build_single():
    """The single-host chain, built and not run: (pipeline, peak)."""
    with bt.Pipeline() as pipeline:
        peak = PeakFinder(build_search_chain(DispersedPulseSource()))
    return pipeline, peak


def run_single():
    pipeline, peak = build_single()
    pipeline.run()
    return peak


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def build_fabric(port=None):
    """The chain split over a two-host loopback fabric: the 'capture'
    host streams the filterbank into the 'filterbank' link (host rings,
    as the bridge carries them); the 'search' host copies it to the card
    and dedisperses.  Returns ({host: FabricHost}, peaks): the search
    host's PeakFinder is ``peaks[0]`` once built."""
    from bifrost_tpu_torch import fabric

    spec = fabric.FabricSpec('fdmt_demo', hosts={
        'capture': {'address': '127.0.0.1', 'role': 'capture'},
        'search': {'address': '127.0.0.1', 'role': 'reduce'},
    }, links={
        'filterbank': {'kind': 'pipe', 'src': 'capture', 'dst': 'search',
                       'port': port or _free_port(), 'window': 2,
                       'gulp_nbyte': NCHAN * GULP * 4},
    })
    peaks = []

    def build_capture(ctx):
        ctx.sink('filterbank', DispersedPulseSource())

    def build_search(ctx):
        peaks.append(PeakFinder(
            build_search_chain(ctx.source('filterbank'))))

    hosts = {}
    # the receiving host first: its listener exists before the sender
    # dials
    for name, builder in (('search', build_search),
                          ('capture', build_capture)):
        hosts[name] = fabric.FabricHost(spec, name, builder, jitter=False)
        hosts[name].build()
    return hosts, peaks


def run_fabric(timeout=120.):
    """Run both hosts, each on its own thread; raise what a host raised,
    or if a host is still running after ``timeout`` seconds."""
    hosts, peaks = build_fabric()
    errors = {}

    def run(name, fh):
        try:
            fh.run(install_signals=False)
        except BaseException as exc:
            errors[name] = exc

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in hosts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        for fh in hosts.values():
            fh.pipeline.shutdown()
        raise RuntimeError('fabric hosts still running after %g s'
                           % timeout)
    for name, exc in errors.items():
        raise RuntimeError('fabric host %r failed: %s' % (name, exc)) \
            from exc
    return peaks[0]


def main(argv):
    peak = run_fabric() if '--fabric' in argv[1:] else run_single()
    snr, row, t = peak.best
    print("%d candidate samples above %.1f; peak %.1f at DM row %d "
          "(true %d), t=%d (true %d), DM = %.3f pc/cm^3"
          % (peak.ncandidates, THRESH, snr, row, D_TRUE, t, T0,
             row * peak.dm_step))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
