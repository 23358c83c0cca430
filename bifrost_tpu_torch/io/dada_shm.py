"""PSRDADA-style shared-memory ring buffers over System V IPC, with no
libpsrdada dependency (the port of ``bifrost_tpu/io/dada_shm.py``, the
same segments byte for byte; reference binding:
python/bifrost/psrdada.py:276, block: blocks/psrdada.py:365).

Architecture follows PSRDADA's dada_hdu/ipcbuf model (psrdada
ipcbuf.c): a *header* ring and a *data* ring, each made of one small
sync segment (ring geometry + progress counters) plus ``nbufs`` fixed
size buffer segments, with two counting semaphores (FULL for readers,
EMPTY for writers) providing flow control.  The data block lives at
``key``, the header block at ``key + 1`` — the psrdada convention used
by dada_db and friends.  Headers are 4096-byte ASCII key/value pages
("HDR_SIZE 4096\\nNBIT 8\\n...") exactly like DADA files.

NOTE on interop: the *byte layout of the sync segment* this module's
rings use at runtime is its own (versioned via a magic).  For psrdada
segments, :func:`decode_psrdada_sync` / :func:`encode_psrdada_sync` and
``IpcRing.read_psrdada_sync`` / ``IpcRing.emit_psrdada_sync`` read and
write an ``ipcsync_t`` layout reconstructed from psrdada's public
ipcbuf.h (golden-fixture-tested at the documented offsets in
tests/test_dada_shm.py; see the layout table below).  CAVEAT: the
layout has NOT been byte-diffed against a real libpsrdada build — validate against a real ``dada_db``
segment before relying on it, and expect at most a one-constant fix.  What
is additionally shared with real PSRDADA: the IPC architecture, key
conventions, the ASCII header page format, and the writer/reader state
machine.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

__all__ = ['IpcRing', 'DadaHDU', 'sysv_available',
           'shm_accounting_available',
           'DADA_HEADER_SIZE', 'DEFAULT_KEY',
           'PSRDADA_SYNC_SIZE', 'decode_psrdada_sync',
           'encode_psrdada_sync']

DADA_HEADER_SIZE = 4096
DEFAULT_KEY = 0xdada

IPC_CREAT = 0o1000
IPC_EXCL = 0o2000
IPC_RMID = 0
SETVAL = 16

_SEM_FULL = 0    # count of filled buffers (readers wait on this)
_SEM_EMPTY = 1   # count of free buffers (writers wait on this)

_MAGIC = 0xB1F0DADA00000001
# sync segment: magic, nbufs, bufsz, w_count, r_count, eod_flag,
#               eod_bufno, eod_nbyte, then nbufs u64 byte-counts
_SYNC_FIXED = struct.Struct('<8Q')

# ---------------------------------------------------------------------------
# PSRDADA ipcsync_t codec.
#
# Models the sync struct of psrdada's public ipcbuf.h (the struct the
# reference's generated bindings wrap, python/bifrost/psrdada.py:276
# via bifrost.libpsrdada_generated) on LP64 x86-64 with
# the library's compile-time defaults IPCBUF_READERS=8, IPCBUF_XFERS=8:
#
#   offset  field                      type
#   0       semkey                     key_t (i32)
#   4       semkey_connect             key_t (i32)
#   8       nbufs                      u64
#   16      bufsz                      u64
#   24      w_buf_curr                 u64
#   32      w_buf_next                 u64
#   40      w_xfer                     i32
#   44      w_state                    i32
#   48      r_bufs[IPCBUF_READERS]     u64[8]
#   112     r_xfers[IPCBUF_READERS]    i32[8]
#   144     r_states[IPCBUF_READERS]   i32[8]
#   176     num_readers                u32     (+4 pad to align u64)
#   184     s_buf[IPCBUF_XFERS]        u64[8]  start-of-data buffer
#   248     s_byte[IPCBUF_XFERS]       u64[8]  start byte within s_buf
#   312     eod[IPCBUF_XFERS]          i8[8]   end-of-data raised
#   320     e_buf[IPCBUF_XFERS]        u64[8]  end-of-data buffer
#   384     e_byte[IPCBUF_XFERS]       u64[8]  end byte within e_buf
#   448     semkey_data[IPCBUF_READERS] i32[8]
#   480     (total)
#
# CAVEAT: no libpsrdada build was at hand to cross-validate against,
# so this codec is a reconstruction of the
# public struct shape, versioned here so a byte-diff against a real
# `dada_db` segment is a one-constant fix.  The golden fixture of the
# JAX package's DADA tests is hand-built to THIS layout independently of
# encode_psrdada_sync.
# ---------------------------------------------------------------------------

IPCBUF_READERS = 8
IPCBUF_XFERS = 8
PSRDADA_SYNC_SIZE = 480
_PSRDADA_HEAD = struct.Struct('<iiQQQQii')           # through w_state
_PSRDADA_RBUFS = struct.Struct('<8Q8i8i')            # r_bufs/r_xfers/r_states
_PSRDADA_XFERS = struct.Struct('<I4x8Q8Q8b8Q8Q8i')   # num_readers..semkey_data


def decode_psrdada_sync(raw):
    """Decode a psrdada-layout ``ipcsync_t`` segment into a dict.
    ``raw`` is bytes-like of >= PSRDADA_SYNC_SIZE bytes (e.g. the shm
    segment a ``dada_db`` created)."""
    raw = bytes(raw[:PSRDADA_SYNC_SIZE])
    if len(raw) < PSRDADA_SYNC_SIZE:
        raise ValueError("psrdada sync segment too small: %d < %d"
                         % (len(raw), PSRDADA_SYNC_SIZE))
    (semkey, semkey_connect, nbufs, bufsz, w_buf_curr, w_buf_next,
     w_xfer, w_state) = _PSRDADA_HEAD.unpack_from(raw, 0)
    off = _PSRDADA_HEAD.size
    rb = _PSRDADA_RBUFS.unpack_from(raw, off)
    off += _PSRDADA_RBUFS.size
    xf = _PSRDADA_XFERS.unpack_from(raw, off)
    return {
        'semkey': semkey, 'semkey_connect': semkey_connect,
        'nbufs': nbufs, 'bufsz': bufsz,
        'w_buf_curr': w_buf_curr, 'w_buf_next': w_buf_next,
        'w_xfer': w_xfer, 'w_state': w_state,
        'r_bufs': list(rb[0:8]), 'r_xfers': list(rb[8:16]),
        'r_states': list(rb[16:24]),
        'num_readers': xf[0],
        's_buf': list(xf[1:9]), 's_byte': list(xf[9:17]),
        'eod': [bool(v) for v in xf[17:25]],
        'e_buf': list(xf[25:33]), 'e_byte': list(xf[33:41]),
        'semkey_data': list(xf[41:49]),
    }


def encode_psrdada_sync(nbufs, bufsz, semkey=0, num_readers=1,
                        w_buf_curr=0, w_buf_next=0, w_xfer=0,
                        w_state=0, r_bufs=None, r_xfers=None,
                        r_states=None, s_buf=None, s_byte=None,
                        eod=None, e_buf=None, e_byte=None,
                        semkey_connect=0, semkey_data=None):
    """Encode a psrdada-layout ``ipcsync_t`` segment (the inverse of
    :func:`decode_psrdada_sync`)."""
    def _arr(v, n, fill=0):
        v = list(v) if v is not None else []
        return (v + [fill] * n)[:n]
    out = bytearray(PSRDADA_SYNC_SIZE)
    _PSRDADA_HEAD.pack_into(out, 0, semkey, semkey_connect, nbufs,
                            bufsz, w_buf_curr, w_buf_next, w_xfer,
                            w_state)
    off = _PSRDADA_HEAD.size
    _PSRDADA_RBUFS.pack_into(out, off,
                             *(_arr(r_bufs, 8) + _arr(r_xfers, 8) +
                               _arr(r_states, 8)))
    off += _PSRDADA_RBUFS.size
    _PSRDADA_XFERS.pack_into(
        out, off, num_readers,
        *(_arr(s_buf, 8) + _arr(s_byte, 8) +
          [1 if v else 0 for v in _arr(eod, 8, False)] +
          _arr(e_buf, 8) + _arr(e_byte, 8) + _arr(semkey_data, 8)))
    return bytes(out)

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
        _libc.shmat.restype = ctypes.c_void_p
        _libc.shmat.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_int]
    return _libc


def sysv_available():
    """Whether System V shm works here (it can be disabled in
    containers)."""
    try:
        libc = _get_libc()
        shmid = libc.shmget(0, 4096, IPC_CREAT | 0o600)   # IPC_PRIVATE
        if shmid < 0:
            return False
        libc.shmctl(shmid, IPC_RMID, None)
        return True
    except Exception:
        return False


def shm_accounting_available():
    """Whether SysV segment ATTACHMENT accounting works here: the
    stale-segment recovery and live-ring protection read nattch from
    ``/proc/sysvipc/shm``, which sandboxed kernels (gVisor-style
    containers) omit even when shmget/shmat themselves work.  Without
    it those protections silently degrade (a live ring cannot be
    distinguished from a stale one) — tests exercising them should
    skip rather than fail (tests/test_dada_shm.py)."""
    if not sysv_available():
        return False
    import errno as errno_mod
    probe_key = 0x5bfb
    libc = _get_libc()
    # EXCL: a pre-existing segment at the probe key belongs to someone
    # else and must not be attached (or RMID'd out from under them)
    shmid = libc.shmget(probe_key, 4096, IPC_CREAT | IPC_EXCL | 0o600)
    if shmid < 0:
        if ctypes.get_errno() == errno_mod.EEXIST:
            return _shm_nattch(probe_key) is not None
        return False
    try:
        return _shm_nattch(probe_key) is not None
    finally:
        libc.shmctl(shmid, IPC_RMID, None)


def _shm_nattch(key):
    """Number of processes attached to the segment at ``key`` (from
    /proc/sysvipc/shm), or None if no such segment."""
    try:
        with open('/proc/sysvipc/shm') as f:
            next(f)
            for line in f:
                parts = line.split()
                if len(parts) >= 7 and int(parts[0]) == key:
                    return int(parts[6])   # nattch column
    except (OSError, ValueError, StopIteration):
        pass
    return None


def _shm_create(key, size):
    """Create a fresh segment.  A STALE segment at the key (crashed
    previous run, zero attachments) is removed first so counters never
    carry over; a LIVE one (attached processes) is an error rather
    than silently destroyed out from under its owner."""
    import errno as errno_mod
    libc = _get_libc()
    shmid = libc.shmget(key, size, IPC_CREAT | IPC_EXCL | 0o666)
    if shmid < 0 and ctypes.get_errno() == errno_mod.EEXIST:
        nattch = _shm_nattch(key)
        if nattch:
            raise OSError(
                errno_mod.EEXIST,
                'DADA segment 0x%x is in use by %d process(es); '
                'destroy it first or use another key' % (key, nattch))
        old = libc.shmget(key, 0, 0o666)
        if old >= 0:
            libc.shmctl(old, IPC_RMID, None)
        shmid = libc.shmget(key, size, IPC_CREAT | IPC_EXCL | 0o666)
    if shmid < 0:
        raise OSError(ctypes.get_errno(), 'shmget(create) failed')
    return shmid


def _destroy_stale_ring(key):
    """Remove ALL IPC objects of a stale ring at ``key`` (sync, every
    buffer segment per its recorded nbufs, semaphores) so a recovery
    run with fewer buffers does not leak the crashed run's extras."""
    import struct as struct_mod
    libc = _get_libc()
    old = libc.shmget(key, 0, 0o666)
    if old < 0:
        return
    try:
        head, addr = _shm_map(old, _SYNC_FIXED.size)
        magic, nbufs, _bufsz = struct_mod.unpack_from('<3Q', head)
        del head
        libc.shmdt(ctypes.c_void_p(addr))
        if magic == _MAGIC:
            for i in range(int(nbufs)):
                bid = libc.shmget(((key << 8) | i) & 0x7FFFFFFF, 0,
                                  0o666)
                if bid >= 0:
                    libc.shmctl(bid, IPC_RMID, None)
        libc.shmctl(old, IPC_RMID, None)
        sem = libc.semget(key, 2, 0o666)
        if sem >= 0:
            libc.semctl(sem, 0, IPC_RMID)
    except OSError:
        pass


def _shm_attach(key, size=0):
    libc = _get_libc()
    shmid = libc.shmget(key, size, 0o666)
    if shmid < 0:
        raise OSError(ctypes.get_errno(),
                      'shmget: no segment at key 0x%x' % key)
    return shmid


def _shm_map(shmid, size):
    libc = _get_libc()
    addr = libc.shmat(shmid, None, 0)
    if addr in (None, ctypes.c_void_p(-1).value):
        raise OSError(ctypes.get_errno(), 'shmat failed')
    buf = (ctypes.c_ubyte * size).from_address(addr)
    return np.frombuffer(buf, np.uint8), addr


class _sembuf(ctypes.Structure):
    _fields_ = [('sem_num', ctypes.c_ushort),
                ('sem_op', ctypes.c_short),
                ('sem_flg', ctypes.c_short)]


class _timespec(ctypes.Structure):
    _fields_ = [('tv_sec', ctypes.c_long),
                ('tv_nsec', ctypes.c_long)]


def _sem_op(semid, num, op, timeout=None):
    """semop / semtimedop.  With a timeout, returns False on expiry
    instead of blocking forever (lets ring waits observe shutdown)."""
    import errno as errno_mod
    sb = _sembuf(num, op, 0)
    libc = _get_libc()
    if timeout is None:
        rc = libc.semop(semid, ctypes.byref(sb), 1)
    else:
        ts = _timespec(int(timeout),
                       int((timeout - int(timeout)) * 1e9))
        rc = libc.semtimedop(semid, ctypes.byref(sb), 1,
                             ctypes.byref(ts))
    if rc < 0:
        err = ctypes.get_errno()
        if timeout is not None and err in (errno_mod.EAGAIN,
                                           errno_mod.EINTR):
            return False
        raise OSError(err, 'semop failed')
    return True


class IpcRing(object):
    """One PSRDADA-style ring: sync segment + nbufs buffer segments +
    a FULL/EMPTY semaphore pair (psrdada analogue: ipcbuf_t)."""

    #: buffer segment i lives at key (ring_key << 8) | i, giving each
    #: ring (data at key, header at key+1) a disjoint buffer key space
    MAX_NBUFS = 256

    def _buf_key(self, i):
        return ((self.key << 8) | i) & 0x7FFFFFFF

    def __init__(self, key, nbufs=None, bufsz=None, create=False):
        libc = _get_libc()
        self.key = key
        self.owner = create
        if create:
            if not nbufs or not bufsz:
                raise ValueError("create=True requires nbufs and bufsz")
            if nbufs > self.MAX_NBUFS:
                raise ValueError("nbufs is limited to %d" % self.MAX_NBUFS)
            if _shm_nattch(key) in (0,):
                _destroy_stale_ring(key)
            self.nbufs, self.bufsz = nbufs, bufsz
            sync_size = _SYNC_FIXED.size + 8 * nbufs
            self._sync_id = _shm_create(key, sync_size)
            self._sync, _ = _shm_map(self._sync_id, sync_size)
            self._write_sync(_MAGIC, nbufs, bufsz, 0, 0, 0, 0, 0)
            self._bufs = []
            self._buf_ids = []
            for i in range(nbufs):
                bid = _shm_create(self._buf_key(i), bufsz)
                self._buf_ids.append(bid)
                self._bufs.append(_shm_map(bid, bufsz)[0])
            # recreate the semaphore set too, in case a stale one
            # holds nonzero counts
            old_sem = libc.semget(key, 2, 0o666)
            if old_sem >= 0:
                libc.semctl(old_sem, 0, IPC_RMID)
            self._semid = libc.semget(key, 2, IPC_CREAT | 0o666)
            if self._semid < 0:
                raise OSError(ctypes.get_errno(), 'semget failed')
            libc.semctl(self._semid, _SEM_FULL, SETVAL, 0)
            libc.semctl(self._semid, _SEM_EMPTY, SETVAL, nbufs)
        else:
            self._sync_id = _shm_attach(key)
            head, head_addr = _shm_map(self._sync_id, _SYNC_FIXED.size)
            magic, nbufs, bufsz = struct.unpack_from('<3Q', head)
            del head
            libc.shmdt(ctypes.c_void_p(head_addr))
            if magic != _MAGIC:
                # is it a real psrdada segment? (dada_db layout)
                hint = ''
                try:
                    pd = IpcRing.read_psrdada_sync(key)
                    if 0 < pd['nbufs'] <= 1 << 20 and pd['bufsz'] > 0:
                        hint = ('; the segment decodes as a psrdada '
                                'ipcsync_t (nbufs=%d bufsz=%d) — read '
                                'it with IpcRing.read_psrdada_sync or '
                                'psrdada tools'
                                % (pd['nbufs'], pd['bufsz']))
                except OSError:
                    pass
                raise IOError(
                    "Segment at key 0x%x is not a bifrost DADA ring "
                    "(magic %x)%s" % (key, magic, hint))
            self.nbufs, self.bufsz = nbufs, bufsz
            sync_size = _SYNC_FIXED.size + 8 * nbufs
            self._sync, _ = _shm_map(self._sync_id, sync_size)
            self._buf_ids = []
            self._bufs = []
            for i in range(nbufs):
                bid = _shm_attach(self._buf_key(i), bufsz)
                self._buf_ids.append(bid)
                self._bufs.append(_shm_map(bid, bufsz)[0])
            self._semid = libc.semget(key, 2, 0o666)
            if self._semid < 0:
                raise OSError(ctypes.get_errno(), 'semget failed')
        self._w_open = None
        self._r_open = None

    # -- sync helpers ------------------------------------------------------
    def _write_sync(self, *vals):
        _SYNC_FIXED.pack_into(self._sync, 0, *vals)

    def _read_sync(self):
        return _SYNC_FIXED.unpack_from(self._sync, 0)

    def _set_field(self, idx, val):
        struct.pack_into('<Q', self._sync, idx * 8, val)

    def _get_field(self, idx):
        return struct.unpack_from('<Q', self._sync, idx * 8)[0]

    def _set_buf_nbyte(self, bufno, nbyte):
        struct.pack_into('<Q', self._sync,
                         _SYNC_FIXED.size + 8 * bufno, nbyte)

    def _get_buf_nbyte(self, bufno):
        return struct.unpack_from(
            '<Q', self._sync, _SYNC_FIXED.size + 8 * bufno)[0]

    # -- writer side (psrdada: ipcio_open / ipcbuf_mark_filled) -----------
    def open_write_buf(self):
        """Block until a buffer is free; return a writable numpy view."""
        _sem_op(self._semid, _SEM_EMPTY, -1)
        w = self._get_field(3)
        self._w_open = w % self.nbufs
        return self._bufs[self._w_open]

    def mark_filled(self, nbyte=None, eod=False):
        """Publish the open write buffer (psrdada: ipcbuf_mark_filled).
        End-of-data is EXPLICIT (``eod=True``, like ipcbuf_enable_eod) —
        a short buffer alone does not end the observation, so streaming
        writers may fill buffers partially."""
        assert self._w_open is not None
        nbyte = self.bufsz if nbyte is None else nbyte
        self._set_buf_nbyte(self._w_open, nbyte)
        w = self._get_field(3)
        if eod:
            self._set_field(5, 1)
            self._set_field(6, w)
            self._set_field(7, nbyte)
        self._set_field(3, w + 1)
        self._w_open = None
        _sem_op(self._semid, _SEM_FULL, +1)

    # -- reader side (psrdada: ipcbuf_get_next_read / mark_cleared) -------
    def open_read_buf(self, timeout=None):
        """Block until a buffer is filled; return (view, nbyte, is_eod),
        or None if ``timeout`` (seconds) expires first."""
        if not _sem_op(self._semid, _SEM_FULL, -1, timeout):
            return None
        r = self._get_field(4)
        bufno = r % self.nbufs
        nbyte = self._get_buf_nbyte(bufno)
        eod = bool(self._get_field(5)) and self._get_field(6) == r
        self._r_open = bufno
        return self._bufs[bufno], nbyte, eod

    def mark_cleared(self):
        assert self._r_open is not None
        self._set_field(4, self._get_field(4) + 1)
        self._r_open = None
        _sem_op(self._semid, _SEM_EMPTY, +1)

    # -- psrdada-layout interop --------------------------------------------
    @classmethod
    def read_psrdada_sync(cls, key):
        """Attach to the shm segment at ``key`` and decode it as a
        psrdada ``ipcsync_t`` (the segment a ``dada_db -k <key>``
        creates).  Returns the decoded dict; raises OSError when no
        segment exists.  CAVEAT: decodes the reconstructed layout
        documented above, which has not been validated against a real
        libpsrdada build — cross-check before relying on the fields."""
        libc = _get_libc()
        shmid = _shm_attach(key)
        buf, addr = _shm_map(shmid, PSRDADA_SYNC_SIZE)
        try:
            return decode_psrdada_sync(bytes(buf))
        finally:
            del buf
            libc.shmdt(ctypes.c_void_p(addr))

    def emit_psrdada_sync(self, key):
        """Write a psrdada-layout ``ipcsync_t`` describing THIS ring's
        geometry and cursors into a fresh shm segment at ``key`` (so
        psrdada-side tooling can inspect the ring).  Returns the shmid;
        the caller owns the segment's lifetime.  Same layout CAVEAT as
        :meth:`read_psrdada_sync`."""
        _, nbufs, bufsz, w, r, eodf, eodb, eodn = self._read_sync()
        raw = encode_psrdada_sync(
            nbufs=nbufs, bufsz=bufsz, semkey=self.key,
            num_readers=1, w_buf_curr=w, w_buf_next=w + 1,
            r_bufs=[r], eod=[bool(eodf)], e_buf=[eodb],
            e_byte=[eodn])
        shmid = _shm_create(key, PSRDADA_SYNC_SIZE)
        buf, addr = _shm_map(shmid, PSRDADA_SYNC_SIZE)
        buf[:] = np.frombuffer(raw, np.uint8)
        del buf
        _get_libc().shmdt(ctypes.c_void_p(addr))
        return shmid

    # -- lifecycle ---------------------------------------------------------
    def destroy(self):
        """Remove the IPC objects (creator side)."""
        libc = _get_libc()
        for bid in self._buf_ids:
            libc.shmctl(bid, IPC_RMID, None)
        libc.shmctl(self._sync_id, IPC_RMID, None)
        libc.semctl(self._semid, 0, IPC_RMID)


class DadaHDU(object):
    """A header + data ring pair (psrdada analogue: dada_hdu_t).
    Data ring at ``key``, header ring at ``key + 1``."""

    def __init__(self, key=DEFAULT_KEY, create=False, data_nbufs=8,
                 data_bufsz=1 << 20, header_nbufs=4,
                 header_bufsz=DADA_HEADER_SIZE):
        self.key = key
        self.data = IpcRing(key, data_nbufs, data_bufsz, create=create)
        self.header = IpcRing(key + 1, header_nbufs, header_bufsz,
                              create=create)

    # -- writer ------------------------------------------------------------
    def write_header(self, fields):
        """Write one observation's ASCII header page."""
        lines = []
        fields = dict(fields)
        fields.setdefault('HDR_SIZE', self.header.bufsz)
        fields.setdefault('HDR_VERSION', '1.0')
        for k, v in fields.items():
            lines.append('%s %s' % (k, v))
        raw = ('\n'.join(lines) + '\n').encode('ascii')
        if len(raw) > self.header.bufsz:
            raise ValueError("header too large")
        buf = self.header.open_write_buf()
        buf[:] = 0
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        self.header.mark_filled()

    def write_data(self, data, eod=False):
        """Write bytes into consecutive data buffers."""
        data = np.asarray(data).reshape(-1).view(np.uint8)
        off = 0
        while off < len(data) or (eod and off == len(data) == 0):
            buf = self.data.open_write_buf()
            n = min(self.data.bufsz, len(data) - off)
            buf[:n] = data[off:off + n]
            off += n
            last = off >= len(data)
            self.data.mark_filled(n, eod=eod and last)
            if last:
                break

    def end_data(self):
        """Mark end-of-data with an empty buffer."""
        self.data.open_write_buf()
        self.data.mark_filled(0, eod=True)

    # -- reader ------------------------------------------------------------
    def read_header(self, timeout=None, should_stop=None):
        """Block for the next observation header; returns the raw ASCII
        bytes (parse with blocks.psrdada._parse_dada_header), or None
        if ``should_stop()`` turns true while waiting."""
        while True:
            got = self.header.open_read_buf(
                timeout if should_stop is not None else None)
            if got is not None:
                buf, nbyte, _ = got
                raw = bytes(buf[:nbyte])
                self.header.mark_cleared()
                return raw
            if should_stop is not None and should_stop():
                return None

    def destroy(self):
        self.data.destroy()
        self.header.destroy()
