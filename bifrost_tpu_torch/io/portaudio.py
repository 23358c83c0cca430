"""Minimal PortAudio binding over ctypes, the port of
``bifrost_tpu/io/portaudio.py`` (reference:
python/bifrost/portaudio.py — same blocking-stream API surface).

Only the pieces the audio block needs: initialize, open a default or
explicit input stream with int8/16/32 samples, blocking read into a
caller buffer, stop/close.  The library handle is injectable
(:func:`set_library`) so the block logic is testable without real
audio hardware.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

__all__ = ['available', 'open', 'Stream', 'PortAudioError',
           'set_library']

paInt8 = 0x10
paInt16 = 0x8
paInt32 = 0x2
_FORMATS = {8: paInt8, 16: paInt16, 32: paInt32}

_pa = None
_initialized = False
_found = None          # cached find_library result
_init_lock = threading.Lock()


class PortAudioError(RuntimeError):
    pass


def set_library(lib):
    """Inject a (real or fake) libportaudio handle; None resets to
    lazy discovery."""
    global _pa, _initialized, _found
    _pa = lib
    _initialized = False
    _found = None


def _find():
    global _found
    if _found is None:
        _found = (ctypes.util.find_library('portaudio'),)
    return _found[0]


def _load():
    global _pa
    if _pa is None:
        name = _find()
        if name is None:
            raise ImportError(
                "libportaudio is not available; install portaudio19 or "
                "use blocks.read_wav for audio files")
        _pa = ctypes.CDLL(name)
    return _pa


def available():
    if _pa is not None:
        return True
    return _find() is not None


def _check(err):
    if err < 0:
        pa = _load()
        try:
            pa.Pa_GetErrorText.restype = ctypes.c_char_p
            msg = pa.Pa_GetErrorText(err).decode('ascii', 'replace')
        except Exception:
            msg = 'error %d' % err
        raise PortAudioError(msg)
    return err


def _ensure_init():
    global _initialized
    with _init_lock:
        if not _initialized:
            _check(_load().Pa_Initialize())
            _initialized = True


class PaStreamParameters(ctypes.Structure):
    _fields_ = [('device', ctypes.c_int),
                ('channelCount', ctypes.c_int),
                ('sampleFormat', ctypes.c_ulong),
                ('suggestedLatency', ctypes.c_double),
                ('hostApiSpecificStreamInfo', ctypes.c_void_p)]


class Stream(object):
    """Blocking-mode input stream (reference: portaudio.py Stream)."""

    def __init__(self, rate=44100, channels=2, nbits=16,
                 frames_per_buffer=1024, input_device=None):
        if nbits not in _FORMATS:
            raise ValueError("nbits must be 8, 16 or 32")
        _ensure_init()
        pa = _load()
        self.rate = rate
        self.channels = channels
        self.nbits = nbits
        self.frames_per_buffer = frames_per_buffer
        self.input_device = input_device
        self._frame_nbyte = channels * nbits // 8
        self._stream = ctypes.c_void_p()
        self._open = False
        if input_device is None:
            _check(pa.Pa_OpenDefaultStream(
                ctypes.byref(self._stream), ctypes.c_int(channels),
                ctypes.c_int(0), ctypes.c_ulong(_FORMATS[nbits]),
                ctypes.c_double(rate), ctypes.c_ulong(frames_per_buffer),
                None, None))
        else:
            params = PaStreamParameters(int(input_device), channels,
                                        _FORMATS[nbits], 0.1, None)
            _check(pa.Pa_OpenStream(
                ctypes.byref(self._stream), ctypes.byref(params), None,
                ctypes.c_double(rate), ctypes.c_ulong(frames_per_buffer),
                ctypes.c_ulong(0), None, None))
        self._open = True          # opened: close() now cleans up
        try:
            _check(pa.Pa_StartStream(self._stream))
        except PortAudioError:
            pa.Pa_CloseStream(self._stream)
            self._open = False
            raise

    def readinto(self, buf):
        """Blocking read filling ``buf`` (any writable buffer whose
        size is a whole number of frames)."""
        view = memoryview(buf).cast('B')
        nframe = len(view) // self._frame_nbyte
        c_buf = (ctypes.c_char * len(view)).from_buffer(view)
        _check(_load().Pa_ReadStream(self._stream, c_buf,
                                     ctypes.c_ulong(nframe)))
        return nframe

    def read(self, nframe):
        out = bytearray(nframe * self._frame_nbyte)
        self.readinto(out)
        return memoryview(out)

    def stop(self):
        if getattr(self, '_open', False):
            _load().Pa_StopStream(self._stream)

    def close(self):
        if getattr(self, '_open', False):
            self.stop()
            _load().Pa_CloseStream(self._stream)
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(mode='r', **kwargs):
    """Open an input stream (reference: bifrost.audio.open)."""
    if mode != 'r':
        raise ValueError("only input ('r') streams are supported")
    return Stream(**kwargs)
