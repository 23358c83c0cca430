"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

into ``bifrost_tpu_torch/_build/`` (listed in ``.gitignore``).  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and never loaded stale.  :func:`build` starts one nvcc per
missing library, all at once, and waits for them together.  Fast math is
not used: the spectrometer's 1e-5 accuracy gate needs IEEE arithmetic,
and the beamform-detect kernel is held bit for bit to its plain version.

A kernel that does not build raises from :func:`build`, and every C
entry returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception.  A wrapper binds each C entry
once (:func:`bind`), passes pointers as plain ints and reads the current
stream's raw handle (:func:`stream_ptr`), so the host time of a launch
is little more than the ctypes call.  The JAX package's capability
probe (``pallas_kernels.available``) is K0 here, ``csrc/probe.cu``
behind :func:`bifrost_tpu_torch.ops.gpu_kernels.available`, which
builds and loads every library of :data:`SOURCES` before it runs the
probe; the engines ask it before they let a kernel race.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ['SOURCES', 'build', 'load', 'bind', 'check', 'stream_ptr',
           'build_logs']

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, 'csrc')
BUILD_DIR = os.path.join(HERE, '_build')

#: kernel sources, by library name
SOURCES = ('spectrometer', 'stokes', 'beamform', 'probe', 'xcorr', 'fdmt',
           'ring_permute')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

#: nvcc's output (ptxas register and shared-memory report) per library
build_logs = {}

_lock = threading.Lock()
_libs = {}
#: C entries bound so far, by (library, function): (library, function)
_bound = {}


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or \
        '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found (looked in %s/bin and on PATH); "
                           "the CUDA kernels cannot be built" % home)
    return found


def _lib_path(name):
    src = os.path.join(CSRC, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (name, digest.hexdigest()[:12]))


def build(names=SOURCES):
    """Build every library of ``names`` that is not built yet, one nvcc
    per source, all started together.  Returns {name: seconds} for the
    libraries built now; raises RuntimeError with nvcc's output when a
    build fails."""
    todo = []
    for name in names:
        src, lib = _lib_path(name)
        if not os.path.exists(lib):
            todo.append((name, src, lib))
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name, src, lib in todo:
        tmp = '%s.%d.tmp' % (lib, os.getpid())
        p = subprocess.Popen([nvcc] + NVCC_FLAGS + ['-o', tmp, src],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((name, lib, tmp, p))
    times, errors = {}, []
    for name, lib, tmp, p in procs:
        out, _ = p.communicate()
        times[name] = time.perf_counter() - t0
        build_logs[name] = out
        if p.returncode != 0:
            errors.append('%s (exit %d):\n%s' % (name, p.returncode, out))
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed for " + '\n'.join(errors))
    return times


def load(name):
    """The ctypes library of kernel source ``name``, built if needed,
    whose functions are called without releasing the GIL."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            # PyDLL: a launch keeps the GIL, as torch's own launches do;
            # the entries only enqueue work, so none holds it for long
            lib = ctypes.PyDLL(_lib_path(name)[1])
            lib.bf_error_string.argtypes = [ctypes.c_int]
            lib.bf_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def bind(name, fn_name, argtypes):
    """``(lib, fn)``: the C entry ``fn_name`` of kernel library ``name``
    with its ``argtypes`` and an int ``restype``, bound at its first use
    and kept, so a launch sets neither again (ctypes rebuilds its argument
    converters on every assignment)."""
    key = (name, fn_name)
    hit = _bound.get(key)
    if hit is None:
        lib = load(name)
        with _lock:
            hit = _bound.get(key)
            if hit is None:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                hit = _bound[key] = (lib, fn)
    return hit


def check(lib, err, what):
    """Raise RuntimeError when a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d: %s"
                           % (what, err, lib.bf_error_string(err).decode()))


_raw_stream = None


def stream_ptr(device):
    """The raw handle, an int, of the current CUDA stream of ``device`` (a
    tensor's device, index included), read on every call (the caller's
    current stream, never a cached one): through
    ``torch._C._cuda_getCurrentRawStream`` where the CUDA build of torch
    has it, which builds no ``torch.cuda.Stream`` object."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
        _raw_stream = raw if raw is not None else (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
    return _raw_stream(device.index)
