"""WAV file source/sink blocks (the port of ``bifrost_tpu/blocks/wav.py``;
reference: python/bifrost/blocks/wav.py), on Python's ``wave``.  Host
(``system``) blocks: 16-bit PCM as a ['time', 'pol'] i16 stream."""

from __future__ import annotations

import os
import wave

import numpy as np

from ..pipeline import SourceBlock, SinkBlock

__all__ = ['WavSourceBlock', 'WavSinkBlock', 'read_wav', 'write_wav']


class WavSourceBlock(SourceBlock):
    """Read .wav audio as a ['time', 'pol'] i16 stream."""

    def create_reader(self, sourcename):
        return wave.open(sourcename, 'rb')

    def on_sequence(self, reader, sourcename):
        nchan = reader.getnchannels()
        rate = reader.getframerate()
        if reader.getsampwidth() != 2:
            raise ValueError("Only 16-bit WAV is supported")
        return [{
            '_tensor': {
                'dtype': 'i16',
                'shape': [-1, nchan],
                'labels': ['time', 'pol'],
                'scales': [[0, 1.0 / rate], None],
                'units': ['s', None],
            },
            'frame_rate': rate,
            'name': sourcename,
        }]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        raw = reader.readframes(ospan.nframe)
        buf = ospan.data.as_numpy()
        arr = np.frombuffer(raw, np.int16).reshape(-1, buf.shape[-1])
        buf[:arr.shape[0]] = arr
        return [arr.shape[0]]


class WavSinkBlock(SinkBlock):
    def __init__(self, iring, path=None, *args, **kwargs):
        super(WavSinkBlock, self).__init__(iring, *args, **kwargs)
        self.path = path or ''
        self._file = None

    def define_valid_input_spaces(self):
        return ('system',)

    def on_sequence(self, iseq):
        hdr = iseq.header
        tensor = hdr['_tensor']
        rate = hdr.get('frame_rate')
        if rate is None:
            rate = int(round(1.0 / tensor['scales'][0][1]))
        name = os.path.basename(str(hdr.get('name', 'output')))
        if not name.endswith('.wav'):
            name += '.wav'
        self._file = wave.open(os.path.join(self.path, name), 'wb')
        nchan = tensor['shape'][1] if len(tensor['shape']) > 1 else 1
        self._file.setnchannels(nchan)
        self._file.setsampwidth(2)
        self._file.setframerate(int(round(rate)))

    def on_data(self, ispan):
        buf = ispan.data.as_numpy()
        self._file.writeframes(
            np.ascontiguousarray(buf.astype(np.int16)).tobytes())

    def on_sequence_end(self, iseq):
        if self._file is not None:
            self._file.close()
            self._file = None


def read_wav(filenames, gulp_nframe, *args, **kwargs):
    """Block: read WAV audio files."""
    return WavSourceBlock(filenames, gulp_nframe, *args, **kwargs)


def write_wav(iring, path=None, *args, **kwargs):
    """Block: write a stream to WAV files."""
    return WavSinkBlock(iring, path, *args, **kwargs)
