"""Raw binary file source/sink blocks (the port of
``bifrost_tpu/blocks/binary_io.py``; reference:
python/bifrost/blocks/binary_io.py).  Host (``system``) blocks, numpy
only: the files they write are byte-identical to the JAX package's."""

from __future__ import annotations

import numpy as np

from ..pipeline import SourceBlock, SinkBlock

__all__ = ['BinaryFileReadBlock', 'BinaryFileWriteBlock',
           'binary_read', 'binary_write']


class BinaryFileReadBlock(SourceBlock):
    """Read flat binary files as a stream with a user-supplied header."""

    def __init__(self, filenames, gulp_size, gulp_nframe, dtype,
                 *args, **kwargs):
        super(BinaryFileReadBlock, self).__init__(filenames, gulp_nframe,
                                                  *args, **kwargs)
        self.gulp_size = gulp_size
        self.dtype = dtype

    def create_reader(self, sourcename):
        return open(sourcename, 'rb')

    def on_sequence(self, reader, sourcename):
        ohdr = {
            '_tensor': {
                'dtype': str(self.dtype),
                'shape': [-1, self.gulp_size],
                'labels': ['time', 'sample'],
                'scales': [[0, 1], [0, 1]],
                'units': [None, None],
            },
            'name': sourcename,
        }
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        buf = ospan.data.as_numpy()
        raw = reader.read(buf.nbytes)
        if len(raw) % ospan.frame_nbyte:
            raw = raw[:len(raw) - len(raw) % ospan.frame_nbyte]
        flat = buf.view(np.uint8).reshape(-1)
        flat[:len(raw)] = np.frombuffer(raw, np.uint8)
        return [len(raw) // ospan.frame_nbyte]


class BinaryFileWriteBlock(SinkBlock):
    """Write the raw bytes of a stream to one file per sequence."""

    def __init__(self, iring, file_ext='out', *args, **kwargs):
        super(BinaryFileWriteBlock, self).__init__(iring, *args, **kwargs)
        self.file_ext = file_ext
        self._file = None

    def define_valid_input_spaces(self):
        return ('system',)

    def on_sequence(self, iseq):
        # keep the full sequence name as the path so distinct inputs with
        # the same basename don't clobber each other
        name = str(iseq.header.get('name', 'output')) or 'output'
        self._file = open(name + '.' + self.file_ext, 'wb')

    def on_data(self, ispan):
        self._file.write(
            np.ascontiguousarray(ispan.data.as_numpy()).tobytes())

    def on_sequence_end(self, iseq):
        if self._file is not None:
            self._file.close()
            self._file = None


def binary_read(filenames, gulp_size, gulp_nframe, dtype, *args, **kwargs):
    """Block: read raw binary files."""
    return BinaryFileReadBlock(filenames, gulp_size, gulp_nframe, dtype,
                               *args, **kwargs)


def binary_write(iring, file_ext='out', *args, **kwargs):
    """Block: write raw binary files."""
    return BinaryFileWriteBlock(iring, file_ext, *args, **kwargs)
