"""ctypes bindings of the native ring runtime, the port of
``bifrost_tpu/native.py``.

The port keeps its own copy of the C++ ring core and the capture and
transmit engines in ``bifrost_tpu_torch/csrc/native/`` (``ring.cpp``,
``capture.cpp``, ``selftest.cpp``, ``util.cpp``), and builds it at first
use with ``g++ -O2 -std=c++17 -fPIC -pthread -shared`` into
``bifrost_tpu_torch/_build/native/``: the package needs nothing beside
it.  The library's name carries a hash of the sources and flags, so an
edited source builds a new library.  Several processes may build at
once (the tests run in parallel workers): the build runs under an
exclusive file lock and writes to a temporary name that ``os.replace``
moves into place, so no process loads a half-written library.

There is no silent fallback: a missing source, or a build or load that
fails, raises :class:`NativeError` (with the path, or the compiler's
output).  ``BF_NO_NATIVE=1`` is the one switch to the Python ring core;
it is read at every ring construction.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ['load', 'available', 'check', 'io_engine_supported',
           'library_path', 'NativeError', 'BFT_OK', 'BFT_END_OF_DATA',
           'BFT_WOULD_BLOCK']

BFT_OK = 0
BFT_END_OF_DATA = 1
BFT_WOULD_BLOCK = 2

SOURCES = ('ring.cpp', 'capture.cpp', 'selftest.cpp', 'util.cpp')
CXX_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-pthread', '-shared')
#: the sources' and the library's directories, inside the package
SOURCE_SUBDIR = 'csrc/native'
BUILD_SUBDIR = '_build/native'

_lock = threading.Lock()
_lib = None


class NativeError(RuntimeError):
    pass


def _package_dir():
    return os.path.dirname(os.path.abspath(__file__))


def _source_dir():
    return os.path.join(_package_dir(), SOURCE_SUBDIR)


def _build_dir():
    return os.path.join(_package_dir(), BUILD_SUBDIR)


def disabled():
    """Whether ``BF_NO_NATIVE`` asks for the Python ring core."""
    return bool(os.environ.get('BF_NO_NATIVE'))


def library_path():
    """The library's path for the current sources and flags (built or
    not)."""
    h = hashlib.sha256()
    h.update(' '.join(('g++',) + CXX_FLAGS).encode())
    for name in SOURCES:
        path = os.path.join(_source_dir(), name)
        try:
            with open(path, 'rb') as f:
                text = f.read()
        except OSError as exc:
            raise NativeError("native source %s cannot be read: %s"
                              % (path, exc))
        h.update(('%s/%s' % (SOURCE_SUBDIR, name)).encode() + b'\0'
                 + text)
    return os.path.join(_build_dir(),
                        'libbifrost_native-%s.so' % h.hexdigest()[:16])


def _build(path):
    """Compile the sources into ``path`` under an exclusive file lock,
    through a temporary name; another process's finished build is
    reused."""
    import fcntl
    os.makedirs(_build_dir(), exist_ok=True)
    with open(os.path.join(_build_dir(), '.build.lock'), 'w') as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return
            tmp = '%s.tmp%d' % (path, os.getpid())
            cmd = ['g++'] + list(CXX_FLAGS) + ['-o', tmp] + \
                [os.path.join(_source_dir(), s) for s in SOURCES]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise NativeError("native build could not start g++: %s"
                                  % exc)
            if p.returncode != 0:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise NativeError("native build failed (%s):\n%s"
                                  % (' '.join(cmd), p.stderr))
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _declare(lib):
    c = ctypes
    P = c.POINTER
    ll = c.c_longlong
    sigs = {
        'bft_ring_create': ([P(c.c_void_p), c.c_char_p], c.c_int),
        'bft_ring_destroy': ([c.c_void_p], c.c_int),
        'bft_ring_resize': ([c.c_void_p, ll, ll, ll], c.c_int),
        'bft_ring_request_resize': ([c.c_void_p, ll, ll, ll,
                                     P(c.c_int)], c.c_int),
        'bft_ring_resize_pending': ([c.c_void_p, P(c.c_int)], c.c_int),
        'bft_ring_resize_hold': ([c.c_void_p, c.c_int], c.c_int),
        'bft_ring_set_core': ([c.c_void_p, c.c_int], c.c_int),
        'bft_ring_geometry': ([c.c_void_p, P(P(c.c_ubyte)), P(ll), P(ll),
                               P(ll)], c.c_int),
        'bft_ring_begin_writing': ([c.c_void_p], c.c_int),
        'bft_ring_end_writing': ([c.c_void_p], c.c_int),
        'bft_ring_begin_sequence': ([c.c_void_p, c.c_char_p, ll,
                                     c.c_char_p, ll, ll,
                                     P(c.c_void_p)], c.c_int),
        'bft_ring_end_sequence': ([c.c_void_p, c.c_void_p], c.c_int),
        'bft_seq_info': ([c.c_void_p, P(c.c_char_p), P(ll),
                          P(c.c_char_p), P(ll), P(ll), P(ll)], c.c_int),
        'bft_seq_end_offset': ([c.c_void_p, P(ll)], c.c_int),
        'bft_ring_reserve': ([c.c_void_p, ll, c.c_int, P(ll), P(ll)],
                             c.c_int),
        'bft_ring_reserve_shed': ([c.c_void_p, ll, ll, P(ll), P(ll),
                                   P(ll)], c.c_int),
        'bft_ring_commit': ([c.c_void_p, ll, ll], c.c_int),
        'bft_capture_create': ([P(c.c_void_p), c.c_int, c.c_int,
                                c.c_void_p, c.c_int, c.c_int, c.c_int,
                                c.c_int, c.c_int], c.c_int),
        'bft_capture_set_header_callback': ([c.c_void_p, c.c_void_p,
                                             c.c_void_p], c.c_int),
        'bft_capture_set_timeout_ms': ([c.c_void_p, c.c_int], c.c_int),
        'bft_capture_set_decimation': ([c.c_void_p, c.c_int], c.c_int),
        'bft_capture_recv': ([c.c_void_p, P(c.c_int)], c.c_int),
        'bft_capture_flush': ([c.c_void_p], c.c_int),
        'bft_capture_end': ([c.c_void_p], c.c_int),
        'bft_capture_stats': ([c.c_void_p, P(ll), P(ll), P(ll), P(ll)],
                              c.c_int),
        'bft_capture_src_ngood': ([c.c_void_p, P(ll), c.c_int], c.c_int),
        'bft_transmit_create': ([P(c.c_void_p), c.c_int, c.c_int],
                                c.c_int),
        'bft_transmit_set_rate': ([c.c_void_p, ll], c.c_int),
        'bft_transmit_set_nbeam': ([c.c_void_p, c.c_int], c.c_int),
        'bft_transmit_set_vdif': ([c.c_void_p, c.c_int, c.c_int,
                                   c.c_int, c.c_int, c.c_int, c.c_int,
                                   c.c_int], c.c_int),
        'bft_transmit_send': ([c.c_void_p, ll, ll, c.c_int, c.c_int,
                               c.c_int, c.c_int, c.c_int, c.c_int,
                               c.c_int, c.c_int, ll,
                               P(c.c_ubyte), c.c_int, c.c_int,
                               c.c_int, P(ll)], c.c_int),
        'bft_transmit_destroy': ([c.c_void_p], c.c_int),
        'bft_selftest': ([], c.c_int),
        'bft_capture_destroy': ([c.c_void_p], c.c_int),
        'bft_reader_create': ([c.c_void_p, c.c_int, P(ll)], c.c_int),
        'bft_reader_destroy': ([c.c_void_p, ll], c.c_int),
        'bft_reader_set_guarantee': ([c.c_void_p, ll, ll, c.c_int],
                                     c.c_int),
        'bft_ring_open_sequence': ([c.c_void_p, c.c_int, c.c_char_p, ll,
                                    P(c.c_void_p)], c.c_int),
        'bft_seq_next': ([c.c_void_p, c.c_void_p, P(c.c_void_p)], c.c_int),
        'bft_reader_acquire': ([c.c_void_p, ll, c.c_void_p, ll, ll, ll,
                                P(ll), P(ll)], c.c_int),
        'bft_reader_release': ([c.c_void_p, ll, ll], c.c_int),
        'bft_ring_overwritten_in': ([c.c_void_p, ll, ll, P(ll)], c.c_int),
        'bft_ring_tail_head': ([c.c_void_p, P(ll), P(ll)], c.c_int),
        'bft_version': ([], c.c_int),
        # util.cpp: affinity, aligned host memory, ProcLog writer
        'bft_affinity_set_core': ([c.c_int], c.c_int),
        'bft_affinity_get_core': ([P(c.c_int)], c.c_int),
        'bft_malloc': ([P(c.c_void_p), ll], c.c_int),
        'bft_free': ([c.c_void_p], c.c_int),
        'bft_memcpy': ([c.c_void_p, c.c_void_p, ll], c.c_int),
        'bft_memcpy2d': ([c.c_void_p, ll, c.c_void_p, ll, ll, ll],
                         c.c_int),
        'bft_memset': ([c.c_void_p, c.c_int, ll], c.c_int),
        'bft_memset2d': ([c.c_void_p, ll, c.c_int, ll, ll], c.c_int),
        'bft_proclog_set_base': ([c.c_char_p], c.c_int),
        'bft_proclog_update': ([c.c_char_p, c.c_char_p, c.c_char_p],
                               c.c_int),
    }
    for fname, (argtypes, restype) in sigs.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load():
    """The native library, built and loaded at first use; None under
    ``BF_NO_NATIVE``.  A failed build or load raises
    :class:`NativeError`."""
    global _lib
    if disabled():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            try:
                _lib = _declare(ctypes.CDLL(path))
            except (OSError, AttributeError) as exc:
                raise NativeError("native library %s failed to load: %s"
                                  % (path, exc))
    return _lib


def available():
    """Whether host rings run on the native core: True unless
    ``BF_NO_NATIVE`` is set (a failed build raises here)."""
    return load() is not None


_io_engine_supported = None


def io_engine_supported():
    """Whether the native capture and transmit engines are compiled in
    (the library builds stubs that return errors off Linux).  Where they
    are, ``io.packet_capture.UDPCapture`` on a native ``system`` ring and
    ``io.packet_writer.UDPTransmit`` run them."""
    global _io_engine_supported
    if _io_engine_supported is None:
        lib = load()
        ok = False
        if lib is not None:
            h = ctypes.c_void_p()
            # fmt 0 / fd -1: create checks only that the engine exists
            if lib.bft_transmit_create(ctypes.byref(h), 0, -1) == 0:
                lib.bft_transmit_destroy(h)
                ok = True
        _io_engine_supported = ok
    return _io_engine_supported


def check(status, what=''):
    if status < 0:
        raise NativeError("native ring error %d %s" % (status, what))
    return status
