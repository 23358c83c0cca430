"""FX correlator demo through the PyTorch/CUDA port, bifrost_tpu_torch:
the single-host chain of examples/fx_correlator.py, block for block.

  synthetic ci8 stations -> copy('cuda') -> FFT(fine -> freq)  [F]
    -> requantize ci8 -> correlate (X-engine, exact int8 path)  [X]
    -> accumulate -> convert_visibilities('storage') -> copy('system')
    -> sink

The X engine consumes the ci8 planes on its exact int32 path
(accuracy='int8'; on the card its race includes the hand-written K7
kernel), so the visibilities equal the int64 oracle's.  The chain runs
on the first CUDA device (cuda:0); a caller that wants the CPU calls
bifrost_tpu_torch.device.set_device('cpu') before run_single().

With ``--fabric`` the same chain is split over a two-host loopback
fabric (bifrost_tpu_torch.fabric): the 'stations' host ships the ci8
voltages over the 'voltages' link into the 'xhost' host, which runs the
F/X chain; the visibilities equal the single-host run's.

Usage:
    python examples/fx_correlator_torch.py             # single host
    python examples/fx_correlator_torch.py --fabric    # two-host fabric
"""

import os
import socket
import sys
import threading

import numpy as np

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import bifrost_tpu_torch as bt

NT, NW, NS, NP = 32, 64, 8, 2    # frames/gulp, window, stations, pols
R, A = 8, 2                      # frames/vis, visibilities accumulated
NGULP = 4
TONE_BIN = 11


class StationSource(bt.SourceBlock):
    """Synthesizes ci8 dual-pol station voltages: a common tone at
    fine bin ``TONE_BIN`` with a per-station phase gradient (so the
    visibility matrix shows off-diagonal fringes) over weak noise."""

    def __init__(self, ngulp=NGULP, **kwargs):
        super(StationSource, self).__init__(['stations'], NT,
                                            space='system', **kwargs)
        self.ngulp = ngulp
        self.count = 0
        rng = np.random.RandomState(19)
        t = np.arange(NT * NW).reshape(NT, NW)
        tone = np.exp(2j * np.pi * TONE_BIN * (t % NW) / NW)
        phase = np.exp(2j * np.pi * np.arange(NS) / NS)
        v = tone[:, :, None, None] * phase[None, None, :, None] * 50
        v = v + 4 * (rng.randn(NT, NW, NS, NP) +
                     1j * rng.randn(NT, NW, NS, NP))
        self.gulp = np.zeros((NT, NW, NS, NP),
                             dtype=np.dtype([('re', 'i1'),
                                             ('im', 'i1')]))
        self.gulp['re'] = np.clip(np.round(v.real), -128, 127)
        self.gulp['im'] = np.clip(np.round(v.imag), -128, 127)

    def create_reader(self, name):
        class R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return R()

    def on_sequence(self, reader, name):
        self.count = 0
        return [{'name': 'stations', 'time_tag': 0,
                 '_tensor': {'shape': [-1, NW, NS, NP],
                             'dtype': 'ci8',
                             'labels': ['time', 'fine', 'station',
                                        'pol'],
                             'scales': [[0, 1]] * 4,
                             'units': [None] * 4}}]

    def on_data(self, reader, ospans):
        if self.count >= self.ngulp:
            return [0]
        self.count += 1
        ospans[0].data.as_numpy()[...] = self.gulp
        return [NT]


class PrintVisibilities(bt.SinkBlock):
    """Prints per-integration fringe diagnostics from the packed
    storage-format (time, baseline, freq, stokes) stream, and keeps each
    integration (``self.visibilities``)."""

    def __init__(self, iring, quiet=False, **kwargs):
        super(PrintVisibilities, self).__init__(iring, **kwargs)
        self.quiet = quiet
        self.visibilities = []

    def on_sequence(self, iseq):
        shape = iseq.header['_tensor']['shape']
        self.log('visibilities: %d baselines x %d channels (storage '
                 'IQUV)' % (shape[1], shape[2]))

    def on_data(self, ispan):
        vis = np.array(ispan.data.as_numpy(), copy=True)
        self.visibilities.append(vis)
        stokes_i = np.abs(vis[..., 0])          # (t, nbl, f)
        for t in range(vis.shape[0]):
            peak = int(np.argmax(stokes_i[t].max(axis=0)))
            cross = stokes_i[t, :, peak]
            self.log('  integration: tone at channel %d, |I| auto %.0f '
                     'cross-mean %.0f'
                     % (peak, cross[0], float(np.mean(cross[1:]))))

    def log(self, text):
        if not self.quiet:
            print(text)


def build_xchain(b):
    """The F -> requantize -> X -> accumulate -> storage device chain,
    as examples/fx_correlator.py builds it."""
    b = bt.blocks.copy(b, space='cuda')
    b = bt.blocks.fft(b, axes='fine', axis_labels='freq')
    b = bt.blocks.quantize(b, 'ci8', scale=1. / NW)
    b = bt.blocks.correlate(b, R, accuracy='int8', fusable=True)
    b = bt.blocks.accumulate(b, A, fusable=True)
    b = bt.blocks.convert_visibilities(b, 'storage')
    return bt.blocks.copy(b, space='system')


def build_single(quiet=False):
    """The single-host pipeline: (pipeline, sink); the sink's
    ``visibilities`` hold every integration once it has run."""
    with bt.Pipeline() as p:
        sink = PrintVisibilities(build_xchain(StationSource()), quiet=quiet)
    return p, sink


def run_single(quiet=False):
    p, sink = build_single(quiet)
    p.run()
    return sink


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def build_fabric(quiet=False, port=None):
    """The chain split over a two-host loopback fabric: the 'stations'
    host captures ci8 voltages into the 'voltages' link (host rings, as
    the bridge carries them); the 'xhost' host copies them to the card
    and runs the F/X chain.  Returns ({host: FabricHost}, sinks): the
    xhost's PrintVisibilities is ``sinks[0]`` once built."""
    from bifrost_tpu_torch import fabric

    spec = fabric.FabricSpec('fxcorr_demo', hosts={
        'stations': {'address': '127.0.0.1', 'role': 'capture'},
        'xhost': {'address': '127.0.0.1', 'role': 'reduce'},
    }, links={
        'voltages': {'kind': 'pipe', 'src': 'stations', 'dst': 'xhost',
                     'port': port or _free_port(), 'window': 2,
                     'gulp_nbyte': NT * NW * NS * NP * 2},
    })
    sinks = []

    def build_stations(ctx):
        ctx.sink('voltages', StationSource())

    def build_xhost(ctx):
        sinks.append(PrintVisibilities(
            build_xchain(ctx.source('voltages')), quiet=quiet))

    hosts = {}
    # the receiving host first: its listener exists before the sender
    # dials
    for name, builder in (('xhost', build_xhost),
                          ('stations', build_stations)):
        hosts[name] = fabric.FabricHost(spec, name, builder, jitter=False)
        hosts[name].build()
    return hosts, sinks


def run_hosts(hosts, timeout=120.):
    """Run each FabricHost on its own thread; raise what a host raised,
    or if a host is still running after ``timeout`` seconds."""
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
    alive = [t for t in threads if t.is_alive()]
    if alive:
        for fh in hosts.values():
            if fh.pipeline is not None:
                fh.pipeline.shutdown()
        raise RuntimeError('fabric hosts still running after %g s'
                           % timeout)
    for name, exc in errors.items():
        raise RuntimeError('fabric host %r failed: %s' % (name, exc)) \
            from exc


def run_fabric(quiet=False):
    hosts, sinks = build_fabric(quiet)
    run_hosts(hosts)
    return sinks[0]


def main(argv):
    if '--fabric' in argv[1:]:
        run_fabric()
    else:
        run_single()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
