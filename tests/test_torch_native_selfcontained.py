"""The port's package stands alone: a copy of ``bifrost_tpu_torch/``
with nothing of the repository beside it (no ``native/``, no
``bifrost_tpu/``) builds its native library from its own
``csrc/native/`` sources, runs a ``NativeRing`` to the same bytes as the
package in the repository, reports its capture and transmit engines, and
neither opens a file nor starts a program under the repository's
``native/`` or ``bifrost_tpu/``.  A library left in the copy's build
directory under the name that the repository's ``native/`` sources
would give is not loaded.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from bifrost_tpu_torch import device, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a short write/read script on one ring, exec'd in this process and in
#: the child; ``run(Ring)`` returns what a reader saw, JSON-ready
SCRIPT = r'''
import numpy as np


def run(Ring):
    ring = Ring(space='system', name='selfcontained')
    data = np.arange(2 * 40 * 3, dtype=np.float32).reshape(2, 40, 3)
    hdr = {'name': 'a', 'gulp_nframe': 4,
           '_tensor': {'shape': [2, -1, 3], 'dtype': 'f32'}}
    out = [type(ring).__name__]
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 4, 12) as seq:
            rd = ring.open_earliest_sequence(guarantee=True)
            off = 0
            for g in range(10):             # wraps the 12-frame buffer
                with seq.reserve(4) as sp:
                    sp.data.as_numpy()[...] = data[:, 4 * g:4 * g + 4]
                    sp.commit(4)
                with rd.acquire(off, 4) as sp:
                    out.append([sp.frame_offset, sp.nframe,
                                np.array(sp.data.as_numpy()).tobytes()
                                .hex()])
                    off += sp.nframe
    rd.close()
    occ = ring.occupancy()
    out.append([ring.total_span, occ['tail'], occ['head']])
    return out
'''

CHILD = r'''
import json
import os
import sys

seen = []


def audit(event, args):
    if event == 'open' and isinstance(args[0], (str, bytes)):
        seen.append(['open', [os.fsdecode(args[0])]])
    elif event == 'subprocess.Popen':
        argv = args[1]
        argv = [argv] if isinstance(argv, (str, bytes)) else list(argv)
        seen.append(['popen', [os.fsdecode(a) for a in
                               [args[0]] + argv if a is not None]])


sys.addaudithook(audit)

import bifrost_tpu_torch
from bifrost_tpu_torch import device, native
from bifrost_tpu_torch.ring import Ring

device.set_device('cpu')
scope = {}
exec(sys.argv[1], scope)
got = scope['run'](Ring)
out = {'package': os.path.dirname(bifrost_tpu_torch.__file__),
       'library': native.load()._name,
       'library_path': native.library_path(),
       'io_engine_supported': native.io_engine_supported(),
       'jax_package': 'bifrost_tpu' in sys.modules,
       'script': got}
out['events'] = list(seen)
print('RESULT ' + json.dumps(out))
'''


def _old_library_name():
    """The name the library had when it was built from the repository's
    ``native/`` sources: their bytes hashed under their bare names."""
    h = hashlib.sha256()
    h.update(' '.join(('g++',) + native.CXX_FLAGS).encode())
    for name in native.SOURCES:
        with open(os.path.join(ROOT, 'native', name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return 'libbifrost_native-%s.so' % h.hexdigest()[:16]


@pytest.fixture(scope='module')
def alone(tmp_path_factory):
    """Run the child on a copy of the package alone; returns (the
    child's report, the copy's root, the planted stale name)."""
    top = tmp_path_factory.mktemp('alone')
    pkg = top / 'bifrost_tpu_torch'
    shutil.copytree(os.path.join(ROOT, 'bifrost_tpu_torch'), pkg,
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    stale = _old_library_name()
    build = pkg / '_build' / 'native'
    build.mkdir(parents=True)
    (build / stale).write_bytes(b'not a library')
    env = {k: v for k, v in os.environ.items()
           if k not in ('BF_NO_NATIVE', 'PYTHONPATH')}
    env.update(PYTHONPATH=str(top), BF_PROCLOG_DIR=str(top / 'proclog'),
               PYTHONDONTWRITEBYTECODE='1')
    p = subprocess.run([sys.executable, '-s', '-c', CHILD, SCRIPT],
                       cwd=str(top), env=env, capture_output=True,
                       text=True, timeout=600)
    lines = [line for line in p.stdout.splitlines()
             if line.startswith('RESULT ')]
    assert p.returncode == 0 and lines, p.stderr[-4000:]
    return json.loads(lines[-1][len('RESULT '):]), top, stale


def test_the_package_alone_builds_and_runs_a_native_ring(alone):
    report, top, _stale = alone
    pkg = str(top / 'bifrost_tpu_torch')
    assert report['package'] == pkg and not report['jax_package']
    assert report['library'] == report['library_path']
    assert report['library'].startswith(
        os.path.join(pkg, '_build', 'native') + os.sep)
    assert report['script'][0] == 'NativeRing'
    # the same script on the repository's package gives the same bytes
    device.set_device('cpu')
    scope = {}
    exec(SCRIPT, scope)
    from bifrost_tpu_torch.ring import Ring
    assert report['script'] == json.loads(json.dumps(scope['run'](Ring)))


def test_the_package_alone_has_its_io_engines(alone):
    report, _top, _stale = alone
    assert report['io_engine_supported'] == sys.platform.startswith(
        'linux')


def test_the_package_alone_reads_nothing_of_the_repository(alone):
    report, top, _stale = alone
    outside = tuple(os.path.join(ROOT, d) + os.sep
                    for d in ('native', 'bifrost_tpu'))
    bad = [(kind, a) for kind, args in report['events'] for a in args
           if os.path.abspath(a).startswith(outside)]
    assert not bad, bad[:5]
    # the build ran in the child, on the copy's own sources
    src = os.path.join(str(top), 'bifrost_tpu_torch', 'csrc', 'native')
    gxx = [args for kind, args in report['events']
           if kind == 'popen' and os.path.basename(args[0]) == 'g++']
    assert len(gxx) == 1
    opened = {a for kind, args in report['events'] if kind == 'open'
              for a in args}
    assert {os.path.join(src, name) for name in native.SOURCES} <= opened
    assert sorted(a for a in gxx[0] if a.endswith('.cpp')) == sorted(
        os.path.join(src, name) for name in native.SOURCES)


def test_a_library_of_the_old_sources_is_not_loaded(alone):
    report, top, stale = alone
    assert os.path.basename(report['library']) != stale
    assert os.path.basename(native.library_path()) != stale
    build = top / 'bifrost_tpu_torch' / '_build' / 'native'
    assert (build / stale).read_bytes() == b'not a library'
    assert os.path.exists(report['library'])


def test_a_missing_source_raises_native_error(monkeypatch, tmp_path):
    """A package without its sources raises NativeError naming the path,
    from library_path() and from load()."""
    monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    monkeypatch.setattr(native, '_source_dir', lambda: str(tmp_path))
    monkeypatch.setattr(native, '_lib', None)
    want = os.path.join(str(tmp_path), native.SOURCES[0])
    for call in (native.library_path, native.load):
        with pytest.raises(native.NativeError) as ei:
            call()
        assert want in str(ei.value)
