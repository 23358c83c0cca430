"""Serialize/deserialize a ring stream to disk — the checkpoint/replay
mechanism (the port of ``bifrost_tpu/blocks/serialize.py``; reference:
python/bifrost/blocks/serialize.py:45-279).  Host (``system``) blocks: a
stream the port serializes is byte for byte what the JAX package writes,
and each package replays the other's files.

On-disk layout per sequence (reference-compatible):
  <name>.bf.json                        — the sequence header (JSON)
  <name>.bf.<frame_offset:012d>.dat     — raw frame data (nringlet == 1)
  <name>.bf.<frame_offset>.<r>.dat      — one file per ringlet lane

Data files rotate when they exceed ``max_file_size`` bytes (default
1 GiB, like the reference blocks/serialize.py:173-179); the
frame-offset filename component makes segments self-describing.

A serialized stream can be re-ingested with DeserializeBlock, giving
pipeline checkpoint/resume of buffered data.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..pipeline import SourceBlock, SinkBlock
from ..ring import split_shape
from ..dtype import DataType

__all__ = ['SerializeBlock', 'DeserializeBlock', 'serialize', 'deserialize']


def _slug(name):
    return str(name).replace('/', '_')


class SerializeBlock(SinkBlock):
    def __init__(self, iring, path=None, max_file_size=None,
                 *args, **kwargs):
        super(SerializeBlock, self).__init__(iring, *args, **kwargs)
        self.path = path or ''
        # reference default: 1 GiB per data file (serialize.py:166)
        self.max_file_size = max_file_size if max_file_size is not None \
            else 1024 ** 3
        self._files = None

    def define_valid_input_spaces(self):
        return ('system',)

    def _data_filenames(self, frame_offset):
        if self._nringlet == 1:
            return ['%s.bf.%012i.dat' % (self._base, frame_offset)]
        ndigit = max(len(str(self._nringlet - 1)), 1)
        return [('%s.bf.%012i.%0' + str(ndigit) + 'i.dat')
                % (self._base, frame_offset, r)
                for r in range(self._nringlet)]

    def _open_files(self, frame_offset):
        self._close_files()
        self._bytes_written = 0
        self._files = [open(f, 'wb')
                       for f in self._data_filenames(frame_offset)]

    def _close_files(self):
        if self._files:
            for f in self._files:
                f.close()
        self._files = None

    def on_sequence(self, iseq):
        hdr = iseq.header
        basename = _slug(hdr.get('name', 'sequence'))
        self._base = os.path.join(self.path, basename)
        with open(self._base + '.bf.json', 'w') as f:
            json.dump(hdr, f, indent=4, sort_keys=True)
        tensor = hdr['_tensor']
        ringlet_shape, _ = split_shape(tensor['shape'])
        self._nringlet = int(np.prod(ringlet_shape)) if ringlet_shape \
            else 1
        self._frame_offset = 0
        self._open_files(0)

    def on_data(self, ispan):
        buf = np.ascontiguousarray(ispan.data.as_numpy())
        per_lane = buf.nbytes // self._nringlet
        # rotate at gulp granularity once the per-lane size limit is hit
        # (reference: serialize.py:173-179)
        if self._bytes_written and \
                self._bytes_written + per_lane > self.max_file_size:
            self._open_files(self._frame_offset)
        if self._nringlet == 1:
            self._files[0].write(buf.tobytes())
        else:
            flat = buf.reshape(self._nringlet, -1)
            for r, f in enumerate(self._files):
                f.write(flat[r].tobytes())
        self._bytes_written += per_lane
        self._frame_offset += ispan.nframe

    def on_sequence_end(self, iseq):
        self._close_files()


class _DeserializeReader(object):
    def __init__(self, basename):
        self.basename = basename
        with open(basename + '.bf.json') as f:
            self.header = json.load(f)
        tensor = self.header['_tensor']
        ringlet_shape, frame_shape = split_shape(tensor['shape'])
        self.ringlet_shape = ringlet_shape
        self.nringlet = int(np.prod(ringlet_shape)) if ringlet_shape else 1
        dtype = DataType(tensor['dtype'])
        nelem = int(np.prod(frame_shape)) if frame_shape else 1
        self.frame_nbyte = nelem * dtype.itemsize_bits // 8
        # discover data-file segments, ordered by frame offset
        esc = glob.escape(basename)
        if self.nringlet == 1:
            groups = []
            for p in sorted(glob.glob(esc + '.bf.*.dat')):
                mid = p[len(basename) + 4:-4]
                if '.' not in mid:      # skip ringlet-style lane files
                    groups.append([p])
        else:
            offsets = sorted({p.rsplit('.', 3)[1]
                              for p in glob.glob(esc + '.bf.*.*.dat')})
            groups = []
            for off in offsets:
                lanes = sorted(glob.glob('%s.bf.%s.*.dat'
                                         % (esc, off)))
                groups.append(lanes)
        if not groups:
            raise IOError("No .dat files found for %s" % basename)
        self._segments = groups
        self._seg_idx = 0
        self.files = [open(p, 'rb') for p in groups[0]]

    def _next_segment(self):
        for f in self.files:
            f.close()
        self._seg_idx += 1
        if self._seg_idx >= len(self._segments):
            self.files = []
            return False
        self.files = [open(p, 'rb')
                      for p in self._segments[self._seg_idx]]
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for f in self.files:
            f.close()
        return False

    def read_frames(self, nframe):
        """Read up to nframe frames per lane, crossing segment-file
        boundaries (reference: BifrostReader.readinto)."""
        want = nframe * self.frame_nbyte
        chunks = [b''] * max(self.nringlet, 1)
        while want > 0 and self.files:
            got = [f.read(want) for f in self.files]
            n = min(len(c) for c in got)
            n -= n % self.frame_nbyte
            chunks = [c + g[:n] for c, g in zip(chunks, got)]
            want -= n
            if want > 0 and not self._next_segment():
                break
        nread = len(chunks[0]) // self.frame_nbyte
        return chunks, nread


#: sourcename suffix marking a looped replay pass (never a legal
#: filename character sequence in the serialize format)
_LOOP_SEP = '#loop'


class DeserializeBlock(SourceBlock):
    """Replay a serialized stream.

    ``loop=N`` (N > 1) replays the whole file set N times: each pass
    re-opens the readers (fresh segment state) and EVERY sequence is
    renumbered ``time_tag = pass * nfiles + ordinal`` — unique and
    strictly increasing regardless of what tags the recording carried
    (recorded tags may be timestamps; reusing them on pass 0 while
    assigning counters later would collide or interleave).  Later
    passes additionally suffix the sequence name with ``.loopN`` so
    downstream sinks/serializers keep the passes apart.

    ``restamp=True`` drops the recorded trace context (the ``_trace``
    key the JAX package's headers carry) from every replayed header, so
    a replay does not claim the recording's identity.  Off by default
    for checkpoint/resume fidelity."""

    def __init__(self, filenames, gulp_nframe, *args, loop=1,
                 restamp=False, **kwargs):
        base = [f[:-len('.bf.json')] if f.endswith('.bf.json') else f
                for f in filenames]
        self.loop = max(int(loop or 1), 1)
        self.restamp = bool(restamp)
        self._nbase = len(base)
        # loop == 1 keeps the bare names (checkpoint/resume fidelity:
        # headers pass through verbatim); looped replay tags every
        # sourcename with (pass, ordinal) so renumbering is
        # deterministic even when the same file repeats in the set
        if self.loop == 1:
            names = list(base)
        else:
            names = ['%s%s%d.%d' % (n, _LOOP_SEP, i, j)
                     for i in range(self.loop)
                     for j, n in enumerate(base)]
        super(DeserializeBlock, self).__init__(names, gulp_nframe,
                                               *args, **kwargs)

    @staticmethod
    def _split_loop(sourcename):
        """(basename, pass_index, ordinal) from a (possibly suffixed)
        sourcename."""
        if _LOOP_SEP in sourcename:
            base, _, idx = sourcename.rpartition(_LOOP_SEP)
            i, _, j = idx.partition('.')
            if i.isdigit() and j.isdigit():
                return base, int(i), int(j)
        return sourcename, 0, 0

    def create_reader(self, sourcename):
        return _DeserializeReader(self._split_loop(sourcename)[0])

    def on_sequence(self, reader, sourcename):
        hdr = dict(reader.header)
        _base, i, j = self._split_loop(sourcename)
        if self.loop > 1:
            # renumber EVERY pass (recorded tags may be arbitrary
            # timestamps — mixing them with assigned counters could
            # collide or go backwards): pass-major, strictly
            # increasing, unique
            hdr['time_tag'] = i * self._nbase + j
            if i:
                hdr['name'] = '%s.loop%d' % (hdr.get('name',
                                                     'sequence'), i)
        if self.restamp:
            hdr.pop('_trace', None)
        return [hdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        chunks, nframe = reader.read_frames(ospan.nframe)
        if nframe == 0:
            return [0]
        buf = ospan.data.as_numpy()
        if reader.nringlet == 1:
            raw = np.frombuffer(chunks[0], np.uint8)
            buf.view(np.uint8).reshape(-1)[:len(raw)] = raw
        else:
            # one .dat file per ringlet lane; lanes are individually
            # contiguous even though the span view is strided
            nring_dims = len(reader.ringlet_shape)
            for r, idx in enumerate(np.ndindex(*buf.shape[:nring_dims])):
                raw = np.frombuffer(chunks[r], np.uint8)
                sub = buf[idx]
                sub.view(np.uint8).reshape(-1)[:len(raw)] = raw
        return [nframe]


def serialize(iring, path=None, max_file_size=None, *args, **kwargs):
    """Block: dump a stream to .bf.json + .bf.*.dat files."""
    return SerializeBlock(iring, path, max_file_size, *args, **kwargs)


def deserialize(filenames, gulp_nframe, *args, **kwargs):
    """Block: replay a serialized stream."""
    return DeserializeBlock(filenames, gulp_nframe, *args, **kwargs)
