"""The port's twelve wire formats (``bifrost_tpu_torch.io.packet_formats``)
against the JAX package's on the same inputs:

- every codec's ``pack`` bytes, ``unpack`` fields and ``decode_batch``
  arrays and masks are equal across the two packages, on seeded random
  headers, with rejected rows (a broken sync word, the invalid bit, a
  datagram of the wrong size) and the composed-``src0`` codecs;
- the JAX package's own golden-byte, parity and rejection tests
  (``tests/test_wire_formats.py``, ``tests/test_decode_batch.py``) run
  against the port's module.

:func:`rehome` runs a JAX test function against port modules: its
globals, and the helper functions of its module, take the port's
objects of the same names, and ``import`` statements inside the test
resolve the mapped module names to the port's modules while it runs.
"""

import contextlib
import sys
import types

import numpy as np
import pytest

import bifrost_tpu.io.packet_formats as JF
import bifrost_tpu_torch.io.packet_formats as TF
from bifrost_tpu_torch import device

from tests import test_decode_batch as JD
from tests import test_wire_formats as JW


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


@contextlib.contextmanager
def _aliased(modules):
    saved = {k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def rehome(fn, modules, **overrides):
    """``fn`` (a test function of a JAX test module) bound to port
    modules: ``modules`` maps JAX module names to the port's modules.
    Globals that are mapped modules, or objects defined in one, become
    the port's; ``overrides`` replaces further globals (keys of shared
    resources, say); the module's helper functions are rebound to the
    same new globals.  Returns a callable that runs with the mapped
    module names aliased in ``sys.modules``."""
    g = dict(fn.__globals__)
    for name, val in list(g.items()):
        if isinstance(val, types.ModuleType):
            if val.__name__ in modules:
                g[name] = modules[val.__name__]
            continue
        owner = getattr(val, '__module__', None)
        if owner in modules and hasattr(modules[owner], name):
            g[name] = getattr(modules[owner], name)
    g.update(overrides)
    for name, val in list(g.items()):
        if isinstance(val, types.FunctionType) and \
                val.__module__ == fn.__module__:
            g[name] = types.FunctionType(val.__code__, g, name,
                                         val.__defaults__, val.__closure__)
    new = g[fn.__name__]

    def run(*args, **kwargs):
        with _aliased(modules):
            return new(*args, **kwargs)
    return run


FORMATS_MAP = {'bifrost_tpu.io.packet_formats': TF}


# ---------------------------------------------------------------------------
# the JAX package's golden, parity and rejection tests on the port
# ---------------------------------------------------------------------------

JW_TESTS = sorted(n for n in dir(JW) if n.startswith('test_') and
                  n != 'test_capture_engine_delegates_src0_to_composed_formats')
JD_TESTS = sorted(n for n in dir(JD) if n.startswith('test_') and
                  n != 'test_sharded_capture_ledger_exact')


@pytest.mark.parametrize('name', JW_TESTS)
def test_jax_golden_cases_on_the_port(name):
    rehome(getattr(JW, name), FORMATS_MAP)()


@pytest.mark.parametrize('name', JD_TESTS)
def test_jax_decode_batch_cases_on_the_port(name):
    rehome(getattr(JD, name), FORMATS_MAP)()


def _probe():
    from bifrost_tpu.io.packet_formats import ChipsFormat as C
    return ChipsFormat, C  # noqa: F821 (a global of the rehomed module)


def test_rehome_reaches_the_port_module():
    """The rehomed tests really hold the port's codecs: a function of the
    JAX test module's globals sees the port's class by global name and
    by import."""
    g = dict(JW.__dict__)
    fn = types.FunctionType(_probe.__code__, g, '_probe')
    fn.__module__ = JW.__name__
    g['_probe'] = fn
    assert fn() == (JF.ChipsFormat, JF.ChipsFormat)
    assert rehome(fn, FORMATS_MAP)() == (TF.ChipsFormat, TF.ChipsFormat)
    import bifrost_tpu.io.packet_formats as after
    assert after is JF


def test_capture_engine_delegates_src0_to_composed_formats():
    """As ``tests/test_wire_formats.py``'s test of the same name, on the
    port's capture engine."""
    from bifrost_tpu_torch.io.packet_capture import _PacketCapture

    class _FakeRing:
        name = 'torch-src0-delegation-test'

    cap = _PacketCapture('pbeam', _FakeRing(), nsrc=8, src0=2,
                         max_payload_size=64, buffer_ntime=4,
                         slot_ntime=4, sequence_callback=lambda d: None)
    assert cap.src0 == 0
    assert cap.fmt.src0 == 2
    assert TF.get_format('pbeam').src0 == 0
    cap = _PacketCapture('cor', _FakeRing(), nsrc=6, src0=1,
                         max_payload_size=64, buffer_ntime=4,
                         slot_ntime=4, sequence_callback=lambda d: None)
    assert cap.fmt.nsrc == 6 and cap.fmt.src0 == 1 and cap.src0 == 0


# ---------------------------------------------------------------------------
# the two packages on the same seeded headers
# ---------------------------------------------------------------------------

def _drx_id(rng):
    return int(rng.randint(1, 8)) | (int(rng.randint(1, 3)) << 3) | \
        (int(rng.randint(0, 2)) << 7)


#: name -> (codec constructor kwargs, desc kwargs of packet k, payload
#: bytes, whether the first 4 bytes are a sync word)
CASES = {
    'simple': ({}, lambda r, k: dict(seq=int(r.randint(0, 2 ** 62))),
               32, False),
    'chips': ({}, lambda r, k: dict(
        seq=int(r.randint(1, 2 ** 40)), src=int(r.randint(0, 16)),
        nsrc=16, tuning=int(r.randint(0, 256)),
        nchan=int(r.randint(1, 256)), chan0=int(r.randint(0, 65536))),
        64, False),
    'pbeam': ({'nbeam': 2}, lambda r, k: dict(
        seq=24 * (700 + k), src=int(r.randint(0, 6)), nsrc=6, nchan=109,
        decimation=24, chan0=436), 436, False),
    'tbn': ({'decimation': 1}, lambda r, k: dict(
        seq=512 * (1000 + k), src=int(r.randint(0, 32)),
        tuning=int(r.randint(0, 2 ** 31)), gain=int(r.randint(0, 65536))),
        1024, True),
    'drx': ({}, lambda r, k: dict(
        seq=40960 * (7 + k) + 4, src=_drx_id(r), decimation=10,
        tuning=int(r.randint(0, 2 ** 31))), 4096, True),
    'drx8': ({}, lambda r, k: dict(
        seq=40960 * (7 + k) + 4, src=_drx_id(r), decimation=10,
        tuning=int(r.randint(0, 2 ** 31))), 8192, True),
    'ibeam': ({'nbeam': 1}, lambda r, k: dict(
        seq=int(r.randint(1, 2 ** 40)), src=int(r.randint(0, 6)), nsrc=6,
        tuning=1, nchan=96, chan0=50), 96, False),
    'cor': ({'nsrc': 6, 'src0': 1}, lambda r, k: dict(
        seq=196000000 * 2 * (50 + k), src=int(r.randint(0, 3)), nsrc=3,
        tuning=(2 << 8) | int(r.randint(1, 3)), decimation=200,
        gain=int(r.randint(0, 16))), 128, True),
    'snap2': ({}, lambda r, k: dict(
        seq=31337 + k, time_tag=1700000000 + k, npol=2, npol_tot=4,
        nchan=96, nchan_tot=192, src=int(r.randint(0, 2)), chan0=384,
        pol0=int(r.choice([0, 2])), nsrc=4), 512, False),
    'vdif': ({'frames_per_second': 25600, 'ref_epoch': 2, 'log2_nchan': 1,
              'nbit': 8, 'station_id': 0x4142}, lambda r, k: dict(
        seq=100 * 25600 + int(r.randint(0, 25600)),
        src=int(r.randint(0, 1024))), 64, False),
    'tbf': ({}, lambda r, k: dict(
        seq=int(r.randint(0, 2 ** 40)), src=int(r.randint(0, 65536)),
        nsrc=64), 6144, True),
    'vbeam': ({}, lambda r, k: dict(
        seq=int(r.randint(0, 2 ** 40)), time_tag=1700000000 + k,
        nchan=32, chan0=64, npol=2), 256, False),
}


def _fields(d):
    if d is None:
        return None
    return {k: getattr(d, k) for k in TF.PacketDesc.__slots__}


class _Raised(str):
    """The type name of an exception a codec raised."""


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as exc:                 # the same refusal in both
        return _Raised(type(exc).__name__)
    return out


def _batch_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype
        else:
            assert x == y


@pytest.mark.parametrize('name', sorted(CASES))
def test_codecs_equal_jax_on_seeded_headers(name):
    kw, make, npay, synced = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    tf, jf = TF.get_format(name, **kw) if kw else TF.get_format(name), \
        JF.get_format(name, **kw) if kw else JF.get_format(name)
    assert type(tf).__name__ == type(jf).__name__
    assert tf.header_size == jf.header_size
    assert getattr(tf, 'frame_size', None) == getattr(jf, 'frame_size', None)
    assert getattr(tf, 'SRC_STEER_BYTE', None) == \
        getattr(jf, 'SRC_STEER_BYTE', None)
    pkts = []
    for k in range(8):
        dk = make(rng, k)
        dk['payload'] = bytes(rng.randint(0, 256, npay).astype(np.uint8))
        wire = tf.pack(TF.PacketDesc(**dk), framecount=k)
        assert wire == jf.pack(JF.PacketDesc(**dk), framecount=k), k
        pkts.append(wire)
    bad = set()
    if synced:
        pkts[-1] = b'\x00\x00\x00\x00' + pkts[-1][4:]
        bad.add(len(pkts) - 1)
    if name == 'vdif':
        w = bytearray(pkts[-1])
        w[3] |= 0x80                          # the invalid bit
        pkts[-1] = bytes(w)
        bad.add(len(pkts) - 1)
    for p in pkts + [pkts[0][:tf.header_size - 1], pkts[0] + b'\x01']:
        t, j = _outcome(tf.unpack, p), _outcome(jf.unpack, p)
        if isinstance(t, _Raised) or isinstance(j, _Raised):
            assert t == j
        else:
            assert _fields(t) == _fields(j)
    arr = np.frombuffer(b''.join(pkts), np.uint8).reshape(len(pkts), -1)
    t, j = _outcome(tf.decode_batch, arr), _outcome(jf.decode_batch, arr)
    assert not isinstance(t, _Raised) and not isinstance(j, _Raised)
    _batch_equal(t, j)
    if len(t) > 3 and t[3] is not None:
        assert {i for i, ok in enumerate(t[3]) if not ok} == bad
    # a receive stride wider than the datagram, with its true length
    wide = np.zeros((len(pkts), arr.shape[1] + 40), np.uint8)
    wide[:, :arr.shape[1]] = arr
    _batch_equal(tf.decode_batch(wide, arr.shape[1]),
                 jf.decode_batch(wide, arr.shape[1]))


def test_registry_equals_jax():
    assert sorted(TF.FORMATS) == sorted(JF.FORMATS)
    for name in TF.FORMATS:
        assert type(TF.FORMATS[name]).__name__ == \
            type(JF.FORMATS[name]).__name__
        assert TF.FORMATS[name].header_size == JF.FORMATS[name].header_size
    with pytest.raises(KeyError):
        TF.get_format('nope')
    assert TF.get_format('chips_64') is TF.FORMATS['chips']
    fmt = TF.CorFormat(nsrc=6)
    assert TF.get_format(fmt) is fmt
