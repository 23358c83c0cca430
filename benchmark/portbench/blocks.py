"""The benchmark's two ends of the chain: a source that behaves as a
capture engine filling a pinned ring by DMA, and a sink that reads the
pinned output ring and keeps the measurement window."""

import threading
import time
import warnings

import numpy as np


def index_stamp(k):
    """The 8 bytes (int8) a gulp carries at its start: its index, as a
    capture engine writes a sequence number, so that no two gulps of a
    run hold the same bytes."""
    return np.frombuffer(np.int64(k).tobytes(), np.int8)


def make_source(bt, header, geom, make_gulp, nslot):
    """A ``cuda_host`` SourceBlock.  The ring holds exactly ``nslot``
    gulps (the H2D copy asks for that much buffering), so gulp k always
    lands on slot k mod nslot.  The first ``nslot`` gulps copy the seeded
    gulps in (set-up); every later gulp only writes its index stamp (8
    bytes), notes its creation time and commits, as a NIC's DMA leaves
    the bytes in place.  A gulp whose span is not on its slot's bytes
    raises."""

    class CaptureSource(bt.SourceBlock):
        def __init__(self):
            super(CaptureSource, self).__init__(
                ['portbench'], geom['gulp_nframe'], space='cuda_host')
            self.count = 0
            #: perf_counter creation stamp of each gulp, by gulp index
            self.stamps = []
            #: (start, end) of each reserve: time blocked on the ring
            self.reserves = []
            self.slot_addr = []
            self.stop = threading.Event()
            self.t_first = self.t_filled = None

        def create_reader(self, name):
            class _Reader(object):
                def __enter__(self):
                    return self

                def __exit__(self, *exc):
                    return False
            return _Reader()

        def on_sequence(self, reader, name):
            return [header]

        def reserve_spans(self, exit_stack, oseqs, igulp_nframes=()):
            t0 = time.perf_counter()
            spans = super(CaptureSource, self).reserve_spans(
                exit_stack, oseqs, igulp_nframes)
            self.reserves.append((t0, time.perf_counter()))
            return spans

        def on_data(self, reader, ospans):
            if self.stop.is_set():
                return [0]
            k = self.count
            buf = ospans[0].data.as_numpy().view(np.int8).reshape(-1)
            addr = buf.ctypes.data
            slot = k % nslot
            if k < nslot:
                import torch
                if k == 0:
                    self.t_first = time.perf_counter()
                src = make_gulp(slot).reshape(-1)
                torch.from_numpy(buf).copy_(src)
                del src
                self.slot_addr.append(addr)
                if k == nslot - 1:
                    self.t_filled = time.perf_counter()
            elif addr != self.slot_addr[slot]:
                raise RuntimeError(
                    'gulp %d landed at 0x%x, not on slot %d (0x%x): the '
                    'ring no longer keeps its slots' % (
                        k, addr, slot, self.slot_addr[slot]))
            buf[:8] = index_stamp(k)
            self.stamps.append(time.perf_counter())
            self.count += 1
            return [geom['gulp_nframe']]

    return CaptureSource()


def make_sink(bt, iring, *, warmup_outputs, seconds, sample_at,
              sample_nbyte, source, on_open=None, on_close=None):
    """A SinkBlock over the pinned output ring that touches no payload
    but for the sampled outputs.  The window opens at the output after
    ``warmup_outputs`` outputs and closes ``seconds`` later; then it
    stops the source.  ``sample_at`` are fractions of the window: the
    first output at or after each is copied for the check."""

    class WindowSink(bt.SinkBlock):
        def __init__(self):
            super(WindowSink, self).__init__(iring)
            #: (receipt time, frame offset, nframe) of every output
            self.outputs = []
            #: (start, end) of each wait for the next output
            self.waits = []
            self.t_open = self.t_close = None
            self.i_open = self.i_close = None
            self.opened = threading.Event()
            self.closed = threading.Event()
            self.samples = []          # (output frame offset, buffer)
            self._bufs = [np.empty(sample_nbyte, np.uint8)
                          for _ in sample_at]
            for b in self._bufs:
                b.fill(0)              # fault the pages in before the run
            self._t_exit = None

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            t = time.perf_counter()
            if self._t_exit is not None:
                self.waits.append((self._t_exit, t))
            self.outputs.append((t, ispan.frame_offset, ispan.nframe))
            n = len(self.outputs)
            if self.t_open is None and n > warmup_outputs:
                self.t_open = t
                self.i_open = n - 1
                if on_open is not None:
                    on_open()
                self.opened.set()
            elif self.t_open is not None and self.t_close is None:
                if t > self.t_open + seconds:
                    self.t_close = t
                    self.i_close = n - 1       # first output past it
                    if on_close is not None:
                        on_close()
                    source.stop.set()
                    self.closed.set()
                else:
                    k = len(self.samples)
                    if k < len(sample_at) and \
                            t >= self.t_open + sample_at[k] * seconds:
                        self._keep(ispan, k)
            self._t_exit = time.perf_counter()

        def _keep(self, ispan, k):
            import torch
            src = ispan.data.as_numpy().view(np.uint8).reshape(-1)
            if src.size != sample_nbyte:
                raise RuntimeError('output of %d bytes, %d expected'
                                   % (src.size, sample_nbyte))
            with warnings.catch_warnings():
                # the read span is a read-only view; it is only read here
                warnings.simplefilter('ignore', UserWarning)
                torch.from_numpy(self._bufs[k]).copy_(
                    torch.from_numpy(src))
            self.samples.append((ispan.frame_offset, self._bufs[k]))

    return WindowSink()
