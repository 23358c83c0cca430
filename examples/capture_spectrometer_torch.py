"""Live UDP capture into a spectrometer through the PyTorch/CUDA port,
bifrost_tpu_torch: the chain of examples/capture_spectrometer.py, block
for block.

A transmitter thread streams CHIPS F-engine packets carrying a complex
tone over loopback (the native transmit engine).  ``UDPCapture`` on the
'system' ring (a native ring) is the native C++ engine: it decodes the
packets and scatters them into the ring.  The pipeline runs on the card:

    chips/UDP -> capture ring -> copy('cuda')
              -> fused[ FFT(fine_time) -> detect('scalar') ]
              -> copy('system') -> peak sink

and the sink reports the detected tone bin.  Loopback needs no network.
The chain runs on the first CUDA device (cuda:0); a caller that wants
the CPU calls bifrost_tpu_torch.device.set_device('cpu') before run().

    python examples/capture_spectrometer_torch.py
"""

import os
import sys
import threading
import time

import numpy as np

try:
    import bifrost_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import bifrost_tpu_torch as bt
from bifrost_tpu_torch.io.packet_capture import (UDPCapture,
                                                 CAPTURE_NO_DATA,
                                                 CAPTURE_INTERRUPTED)
from bifrost_tpu_torch.io.packet_writer import HeaderInfo, UDPTransmit
from bifrost_tpu_torch.io.udp_socket import Address, UDPSocket
from bifrost_tpu_torch.stages import FftStage, DetectStage

NROACH = 2            # F-engine boards (packet sources)
NTIME = 256           # fine-time samples per source and slot
NSEQ = 32             # time slots to stream
TONE_BIN = 37
BUF_NTIME = 8
TIMEOUT = 60.0        # the longest any wait of the run may take


def make_packets():
    """ci8 tone payloads: (seq, roach, NTIME complex int8 pairs), then
    two buffers of zeros that push the last data out of the window."""
    t = np.arange(NTIME)
    tone = np.exp(2j * np.pi * TONE_BIN * t / NTIME)
    pld = np.zeros((NSEQ + 2 * BUF_NTIME, NROACH, NTIME, 2), np.int8)
    pld[:NSEQ, :, :, 0] = np.round(50 * tone.real).astype(np.int8)
    pld[:NSEQ, :, :, 1] = np.round(50 * tone.imag).astype(np.int8)
    return pld.reshape(NSEQ + 2 * BUF_NTIME, NROACH, -1)


def on_sequence(desc):
    return 0, {'name': 'chips-tone', 'time_tag': 0,
               '_tensor': {'shape': [-1, NROACH, NTIME], 'dtype': 'ci8',
                           'labels': ['time', 'roach', 'fine_time'],
                           'scales': [[0, 1]] * 3,
                           'units': [None] * 3},
               'gulp_nframe': BUF_NTIME}


def run():
    """Stream, capture and detect; returns the detected spectrum summed
    over time and boards (NTIME bins) and the capture engine's name."""
    rx = UDPSocket().bind(Address('127.0.0.1', 0))
    port = rx.sock.getsockname()[1]
    rx.set_timeout(0.5)
    tx_sock = UDPSocket().connect(Address('127.0.0.1', port))
    ring = bt.Ring(space='system', name='capture')
    capture = UDPCapture('chips', rx, ring, NROACH, 0, NTIME * 2,
                         BUF_NTIME, BUF_NTIME, on_sequence)
    total = np.zeros(NTIME)
    box = {}
    sent = threading.Event()

    class PeakSink(bt.SinkBlock):
        def on_sequence(self, iseq):
            print("sequence: %s  tensor %s"
                  % (iseq.header['name'], iseq.header['_tensor']['shape']))

        def on_data(self, ispan):
            spec = np.asarray(ispan.data.as_numpy())   # (t, roach, F)
            total[:] += spec.sum(axis=(0, 1))

    def run_capture():
        # an idle socket ends the capture once the transmitter is done
        # (it waits for the pipeline after the first slot)
        try:
            deadline = time.monotonic() + TIMEOUT
            while time.monotonic() < deadline:
                if capture.recv() in (CAPTURE_NO_DATA, CAPTURE_INTERRUPTED) \
                        and sent.is_set():
                    break
        except BaseException as exc:
            box['capture'] = exc
        finally:
            capture.end()

    def run_pipeline():
        try:
            pipeline.run()
        except BaseException as exc:
            box['pipeline'] = exc

    data = make_packets()
    hi = HeaderInfo()
    hi.set_nsrc(NROACH)
    hi.set_nchan(1)
    with bt.Pipeline() as pipeline:
        b = bt.blocks.copy(ring, space='cuda')
        b = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='fine_freq'),
                                DetectStage('scalar')])
        b = bt.blocks.copy(b, space='system')
        PeakSink(b)
        threads = [threading.Thread(target=run_pipeline, daemon=True),
                   threading.Thread(target=run_capture, daemon=True)]
        for th in threads:
            th.start()
        with UDPTransmit('chips', tx_sock) as tx:
            print("capture engine: %s, transmit engine: %s"
                  % (type(capture).__name__, type(tx).__name__))
            try:
                # CHIPS wire sequence numbers are 1-based; the first slot
                # opens the sequence, the rest waits for the copy block's
                # reader so the capture cannot lap it
                tx.send(hi, 1, 1, 0, 1, data[:1])
                # (a pipeline that ended at once, as under BF_LINT=1, has
                # no reader to wait for)
                deadline = time.monotonic() + TIMEOUT
                while not ring._readers and time.monotonic() < deadline \
                        and not box and threads[0].is_alive():
                    time.sleep(0.01)
                tx.send(hi, 2, 1, 0, 1, data[1:])
            finally:
                sent.set()
        for th in threads:
            th.join(TIMEOUT)
            if th.is_alive():
                pipeline.shutdown()
                raise RuntimeError("capture_spectrometer: %s did not end"
                                   % th.name)
    tx_sock.close()
    rx.close()
    for exc in box.values():
        raise exc
    return total, type(capture).__name__


def main():
    total, engine = run()
    peak = int(np.argmax(total)) if total.any() else None
    print("detected tone at fine bin %s (expected %d)" % (peak, TONE_BIN))
    if peak != TONE_BIN:
        raise SystemExit("tone not detected!")
    print("OK")


if __name__ == '__main__':
    main()
