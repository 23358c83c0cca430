"""The port's transfer engine (bifrost_tpu_torch.xfer) and the ring's
deferred fills, held against the JAX package's engine and ring in the
same process: every non-donation test of tests/test_xfer_async.py runs
the same seeded numpy inputs through both packages, compares their
outputs byte for byte and the counters the two share, plus a fault at
``xfer.result`` that poisons the output ring in both, the readers,
wrapped writers and ``resize`` that wait on pending fills, and the ci8
FFT -> Stokes -> reduce chain through both pipelines.

The port runs on the CPU device here: a D2H completes when its future is
read, and ``zero_copy=False`` drives the pinned-slot protocol with the
pool's completion predicate.  Tolerance: bit for bit between the two
engines and between async and strict runs; 1e-5 relative to the maximum
between the two packages' FFT chains (float32 FFTs in another order)."""

import contextlib
import gc
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import xfer as jxfer
from bifrost_tpu.ring import Ring as JRing
from bifrost_tpu.supervision import PipelineRuntimeError as \
    JPipelineRuntimeError
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.testing import faults as jfaults
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, xfer
from bifrost_tpu_torch.ring import Ring
from bifrost_tpu_torch.telemetry import counters
from bifrost_tpu_torch.testing import faults
from tests.test_torch_bounded import run_bounded

GATE = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    device.set_device('cpu')
    counters.reset()
    jcounters.reset()
    yield
    faults.clear()
    jfaults.clear()
    xfer.reset_engine()
    jxfer.reset_engine()


def _same(*names):
    """The named counters are equal in both packages."""
    got = counters.snapshot()
    want = jcounters.snapshot()
    for n in names:
        assert got.get(n, 0) == want.get(n, 0), \
            '%s: port %s, JAX %s' % (n, got.get(n, 0), want.get(n, 0))


# ---------------------------------------------------------------------------
# staging aliasing safety
# ---------------------------------------------------------------------------

def test_to_device_does_not_alias_recycled_host_memory():
    """A writer recycling its host buffer right after to_device must not
    change the device copy (tests/test_xfer_async.py:27)."""
    got = {}
    for name, mod in (('port', xfer), ('jax', jxfer)):
        eng = mod.TransferEngine()
        ringbuf = np.arange(64 * 1024, dtype=np.float32).reshape(64, 1024)
        d = eng.to_device(ringbuf)
        ringbuf[...] = -1.0
        got[name] = np.asarray(d.numpy() if name == 'port' else d)
    want = np.arange(64 * 1024, dtype=np.float32).reshape(64, 1024)
    assert np.array_equal(got['port'], want)
    assert np.array_equal(got['jax'], want)
    _same('xfer.h2d_issued', 'xfer.h2d_bytes', 'xfer.h2d_unstaged')


def test_to_device_alias_safe_under_compute():
    """Recycling the source while a computation on the tensor is pending
    must not change its result (:39)."""
    import jax
    src = np.full((512, 512), 1.0, np.float32)
    jeng = jxfer.TransferEngine()
    jd = jeng.to_device(src.copy())
    jy = jax.jit(lambda x: (x @ x).sum())(jd)
    eng = xfer.TransferEngine()
    d = eng.to_device(src)
    y = (d @ d).sum()
    del d, jd
    src[...] = 0.0
    gc.collect()
    eng.to_device(np.zeros((512, 512), np.float32))
    jeng.to_device(np.zeros((512, 512), np.float32))
    assert float(y) == float(jy) == 512.0 * 512 * 512


def test_staging_pool_recycles_only_completed_transfers():
    """The slot protocol (zero_copy=False): a slot returns to the pool
    only once its transfer is observed complete; a slot whose tensor died
    unobserved is dropped, not reused (:57)."""
    keys = {'port': ((256, 256), 'float32'), 'jax': ((256, 256), 'float32')}
    for name, mod in (('port', xfer), ('jax', jxfer)):
        eng = mod.TransferEngine(staging=2, zero_copy=False)
        a = np.ones((256, 256), np.float32)
        d1 = eng.to_device(a)
        if name == 'jax':
            d1.block_until_ready()
        d2 = eng.to_device(a * 2)
        pool = eng._pool
        assert pool._nalloc[keys[name]] <= 2
        slot_entry = [s for s in pool._busy if s.ref() is d2]
        assert slot_entry
        del d2
        gc.collect()
        assert slot_entry[0].recycled
        free = pool._free.get(keys[name], [])
        bufs = [b[1] if name == 'port' else b for b in free]
        assert all(b is not slot_entry[0].host if name == 'port'
                   else id(b) != id(slot_entry[0].buf) for b in bufs)
        if name == 'port':
            # the port's CPU slot path copies out of the slot; the JAX
            # CPU backend aliases it, which is why it runs zero-copy there
            assert np.array_equal(d1.numpy(), a)
    _same('xfer.h2d_staged', 'xfer.h2d_unstaged', 'xfer.h2d_issued')
    assert counters.get('xfer.h2d_staged') == 2


def test_staging_pool_waits_for_the_completion_predicate():
    """A busy slot is not reused while its copy's completion predicate is
    false: the next transfer of the key takes a new slot, then a fresh
    buffer once the key's slots are all busy; once the copies complete
    the slots recycle.  Values stay right throughout."""
    eng = xfer.TransferEngine(staging=2, zero_copy=False)
    pool = eng._pool
    done = {'v': False}
    pool.ready = lambda slot: done['v']
    rng = np.random.RandomState(3)
    arrs = [rng.randn(64, 128).astype(np.float32) for _ in range(6)]
    outs = [eng.to_device(a) for a in arrs[:3]]
    assert counters.get('xfer.h2d_staged') == 2
    assert counters.get('xfer.h2d_unstaged') == 1
    assert pool._nalloc[((64, 128), 'float32')] == 2
    done['v'] = True
    outs += [eng.to_device(a) for a in arrs[3:]]
    assert counters.get('xfer.h2d_staged') == 5
    assert pool._nalloc[((64, 128), 'float32')] == 2
    for a, d in zip(arrs, outs):
        assert np.array_equal(d.numpy(), a)


def test_slot_of_a_dead_tensor_is_retired():
    """A slot whose tensor died before its completion was observed is
    retired, never handed out again, and the next transfer of the key is
    still right (the JAX package's donated-array case, :88: donation
    deletes the array the same way)."""
    from bifrost_tpu.ops.common import donating_jit
    a = np.ones((128, 128), np.float32)
    jeng = jxfer.TransferEngine(staging=2, zero_copy=False)
    jd = jeng.to_device(a)
    jd.block_until_ready()
    jslot = [s for s in jeng._pool._busy if s.ref() is jd][0]
    jy = donating_jit(lambda x: x + 1.0, donate_argnums=(0,))(jd)
    jd2 = jeng.to_device(a * 3)
    eng = xfer.TransferEngine(staging=2, zero_copy=False)
    d = eng.to_device(a)
    slot = [s for s in eng._pool._busy if s.ref() is d][0]
    y = d + 1.0
    del d
    gc.collect()
    d2 = eng.to_device(a * 3)
    assert np.array_equal(d2.numpy(), np.asarray(jd2))
    assert float(y[0, 0]) == float(jy[0, 0]) == 2.0
    assert slot.recycled and jslot.recycled
    assert all(h is not slot.host
               for bufs in eng._pool._free.values() for _, h in bufs)


def test_to_device_empty_array():
    """Zero-size gulps transfer cleanly (:113)."""
    for mod in (xfer, jxfer):
        for zc in (True, False):
            d = mod.TransferEngine(zero_copy=zc).to_device(
                np.empty((0, 4), np.float32))
            assert tuple(d.shape) == (0, 4)
        d = mod.TransferEngine().to_device(np.float32(3.0))
        assert tuple(d.shape) == ()
    _same('xfer.h2d_issued', 'xfer.h2d_bytes')


def test_strided_span_ships_with_one_copy():
    """A strided host span (a ringlet ring's view) reaches the device
    without a contiguous copy first: the staging copy reads it in place,
    and the values equal the JAX engine's."""
    rng = np.random.RandomState(4)
    buf = rng.randn(3, 40).astype(np.float32)
    span = buf[:, 5:37]
    assert not span.flags.c_contiguous
    eng = xfer.TransferEngine(zero_copy=False)
    calls = []
    real = np.copyto

    def spy(dst, src, **kw):
        calls.append(src)
        return real(dst, src, **kw)

    np.copyto = spy
    try:
        d = eng.to_device(span)
    finally:
        np.copyto = real
    assert len(calls) == 1 and calls[0] is span
    assert np.array_equal(d.numpy(), np.asarray(jxfer.to_device(span)))


# ---------------------------------------------------------------------------
# non-blocking D2H
# ---------------------------------------------------------------------------

def test_out_of_order_completion_drain():
    """Futures may be read in any order; drain retires what completed
    without disturbing the rest (:166)."""
    for mod in (xfer, jxfer):
        eng = mod.TransferEngine(depth=16)
        arrs = [np.full((32, 32), i, np.float32) for i in range(8)]
        futs = [eng.to_host_async(eng.to_device(a)) for a in arrs]
        for i in (5, 1, 6, 2):
            assert np.array_equal(futs[i].result(), arrs[i])
        eng.drain()
        for i in (7, 0, 3, 4):
            assert np.array_equal(futs[i].result(), arrs[i])
        assert eng.outstanding == 0
    _same('xfer.d2h_issued', 'xfer.d2h_bytes', 'xfer.d2h_async',
          'xfer.h2d_issued')


def test_async_queue_bound_forces_oldest():
    """More than ``depth`` outstanding transfers retire the oldest first
    (:181)."""
    for mod in (xfer, jxfer):
        eng = mod.TransferEngine(depth=2)
        futs = [eng.to_host_async(eng.to_device(
            np.full((16,), i, np.float32))) for i in range(6)]
        assert all(f.done for f in futs[:4])
        assert eng.outstanding <= 2
    _same('xfer.d2h_async', 'xfer.d2h_issued')


def test_complex_roundtrip_via_futures():
    """complex64 crosses whole in the port (no plane split) and equals
    the JAX engine's planes round trip (:192)."""
    c = (np.random.RandomState(0).randn(32, 16) +
         1j * np.random.RandomState(1).randn(32, 16)).astype(np.complex64)
    got = {}
    for name, mod in (('port', xfer), ('jax', jxfer)):
        eng = mod.TransferEngine()
        got[name] = eng.to_host_async(eng.to_device(c)).result()
        assert got[name].dtype == np.complex64
    assert np.array_equal(got['port'], c)
    assert np.array_equal(got['port'], got['jax'])
    _same('xfer.d2h_issued', 'xfer.d2h_bytes', 'xfer.h2d_bytes')


def test_to_host_fills_out():
    """to_host(t, out) lands the bytes in ``out`` (a strided view
    included) and returns it."""
    t = torch.arange(37 * 100, dtype=torch.float32).reshape(37, 100)
    ring = np.zeros((37, 160), np.float32)
    span = ring[:, 40:140]
    assert xfer.to_host(t, span) is span
    assert np.array_equal(ring[:, 40:140], t.numpy())
    assert not ring[:, :40].any() and not ring[:, 140:].any()


def test_strict_env_disables_async(monkeypatch):
    """BF_SYNC_STRICT=1 completes a future before returning (:261)."""
    monkeypatch.setenv('BF_SYNC_STRICT', '1')
    for mod in (xfer, jxfer):
        assert not mod.async_enabled()
        eng = mod.TransferEngine()
        fut = eng.to_host_async(eng.to_device(np.ones(4, np.float32)))
        assert fut.done
    _same('xfer.d2h_async', 'xfer.h2d_unstaged')


def test_to_device_batch_equals_jax():
    """K gulps through one staging buffer and one copy."""
    rng = np.random.RandomState(5)
    arrs = [rng.randint(-100, 100, (16, 8)).astype(np.int16)
            for _ in range(3)]
    got = xfer.TransferEngine(zero_copy=False).to_device_batch(arrs)
    want = jxfer.TransferEngine().to_device_batch(arrs)
    assert np.array_equal(got.numpy(), np.asarray(want))
    _same('xfer.h2d_batched', 'xfer.h2d_issued', 'xfer.h2d_bytes')
    with pytest.raises(ValueError):
        xfer.to_device_batch([arrs[0], arrs[0][:3]])


# ---------------------------------------------------------------------------
# deferred fills on the ring
# ---------------------------------------------------------------------------

def _ring_writes(ring_cls, mod, data, hdr, nbuf, commits, check=None):
    """Write ``data`` in 8-frame gulps of fills into a ring of ``nbuf``
    frames (``commits`` frames committed per gulp), then read frames
    [0, nread) back."""
    ring = ring_cls(space='system')
    eng = mod.TransferEngine(depth=16)
    fills = []
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 8, nbuf) as seq:
            for i, g0 in enumerate(range(0, data.shape[0], 8)):
                dev = eng.to_device(data[g0:g0 + 8])
                with seq.reserve(8) as sp:
                    fill = eng.host_fill(dev, 'f32', sp.data.as_numpy())
                    sp.set_fill(fill)
                    sp.commit(commits[i])
                fills.append(fill)
            if check is not None:
                return check(ring, fills, eng)
    return ring, fills, eng


def test_early_completed_fill_still_mirrors_ghost(monkeypatch):
    """With the queue off, fills complete before the span closes; the
    ghost mirror of a wrapped span still runs, at attach (:124)."""
    monkeypatch.setenv('BF_XFER_ASYNC', '0')
    monkeypatch.setenv('BF_NO_NATIVE', '1')
    rng = np.random.RandomState(21)
    data = rng.randn(24, 16).astype(np.float32)
    hdr = simple_header([-1, 16], 'f32', gulp_nframe=8)

    def read(ring, fills, eng):
        assert all(f.done for f in fills)
        with ring.open_earliest_sequence(guarantee=False) as rs:
            with rs.acquire(18, 4) as span:
                return np.array(span.data.as_numpy(), copy=True)

    got = _ring_writes(Ring, xfer, data, deepcopy(hdr), 20, [8] * 3, read)
    want = _ring_writes(JRing, jxfer, data, deepcopy(hdr), 20, [8] * 3,
                        read)
    assert np.array_equal(got, data[18:22])
    assert np.array_equal(got, want)


def test_partial_commit_fill_completes_synchronously():
    """A partially committed span's fill completes at close, and the
    rolled-back frames re-reserved by the next span are not clobbered
    (:269)."""
    rng = np.random.RandomState(8)
    data = rng.randn(8, 16).astype(np.float32)
    fresh = rng.randn(8, 16).astype(np.float32)
    out = {}
    for name, ring_cls, mod in (('port', Ring, xfer),
                                ('jax', JRing, jxfer)):
        hdr = simple_header([-1, 16], 'f32', gulp_nframe=8)
        ring = ring_cls(space='system')
        eng = mod.TransferEngine(depth=16)
        with ring.begin_writing() as w:
            with w.begin_sequence(hdr, 8, 24) as seq:
                dev = eng.to_device(data)
                with seq.reserve(8) as sp:
                    fill = eng.host_fill(dev, 'f32', sp.data.as_numpy())
                    sp.set_fill(fill)
                    sp.commit(4)
                assert fill.done
                with seq.reserve(8) as sp2:
                    sp2.data.as_numpy()[...] = fresh
                    sp2.commit(8)
                eng.drain(block=True)
                with ring.open_earliest_sequence(guarantee=False) as rs:
                    with rs.acquire(0, 12) as span:
                        out[name] = np.array(span.data.as_numpy(),
                                             copy=True)
    assert np.array_equal(out['port'][:4], data[:4])
    assert np.array_equal(out['port'][4:12], fresh)
    assert np.array_equal(out['port'], out['jax'])


def test_zero_commit_cancels_the_fill():
    """A span that commits nothing cancels its fill: no late write lands
    in the rolled-back bytes."""
    rng = np.random.RandomState(9)
    data = rng.randn(8, 16).astype(np.float32)
    for ring_cls, mod in ((Ring, xfer), (JRing, jxfer)):
        hdr = simple_header([-1, 16], 'f32', gulp_nframe=8)
        ring = ring_cls(space='system')
        eng = mod.TransferEngine(depth=16)
        with ring.begin_writing() as w:
            with w.begin_sequence(hdr, 8, 24) as seq:
                dev = eng.to_device(data)
                with seq.reserve(8) as sp:
                    view = sp.data.as_numpy()
                    fill = eng.host_fill(dev, 'f32', view)
                    sp.set_fill(fill)
                    sp.commit(0)
                assert fill.done and fill.error is None
                eng.drain(block=True)
                assert not view.any()


def _pending_fills(ring_cls, mod, data, nbuf=24):
    """Three 8-frame fills committed, none completed yet."""
    ring = ring_cls(space='system')
    eng = mod.TransferEngine(depth=16)
    w = ring.begin_writing()
    hdr = simple_header([-1, 16], 'f32', gulp_nframe=8)
    seq = w.begin_sequence(hdr, 8, nbuf)
    fills = []
    for g0 in (0, 8, 16):
        dev = eng.to_device(data[g0:g0 + 8])
        with seq.reserve(8) as sp:
            fill = eng.host_fill(dev, 'f32', sp.data.as_numpy())
            sp.set_fill(fill)
            sp.commit(8)
        fills.append(fill)
    return ring, w, seq, fills


def test_reader_waits_on_the_fills_it_overlaps():
    """A reader completes exactly the fills its span overlaps before it
    sees the bytes."""
    data = np.random.RandomState(10).randn(24, 16).astype(np.float32)
    for ring_cls, mod in ((Ring, xfer), (JRing, jxfer)):
        ring, w, seq, fills = _pending_fills(ring_cls, mod, data)
        assert not any(f.done for f in fills)
        with ring.open_earliest_sequence(guarantee=False) as rs:
            with rs.acquire(6, 4) as span:
                got = np.array(span.data.as_numpy(), copy=True)
        assert [f.done for f in fills] == [True, True, False]
        assert np.array_equal(got, data[6:10])
        seq.end()
        w.__exit__(None, None, None)


def test_wrapped_writer_waits_on_the_fills_it_overwrites():
    """A reservation that wraps onto a pending fill's bytes completes
    that fill first, and leaves the others pending."""
    data = np.random.RandomState(11).randn(24, 16).astype(np.float32)
    for ring_cls, mod in ((Ring, xfer), (JRing, jxfer)):
        ring, w, seq, fills = _pending_fills(ring_cls, mod, data)
        assert ring.total_span == 24 * 16 * 4
        # frames [24, 32) reuse the bytes of frames [0, 8)
        with seq.reserve(8) as sp:
            assert [f.done for f in fills] == [True, False, False]
            sp.commit(0)
        seq.end()
        w.__exit__(None, None, None)


def test_resize_waits_for_pending_fills():
    """A resize that re-lays out the buffer completes every pending fill
    first, and the data survives the re-layout."""
    data = np.random.RandomState(12).randn(24, 16).astype(np.float32)
    out = {}
    for name, ring_cls, mod in (('port', Ring, xfer),
                                ('jax', JRing, jxfer)):
        ring, w, seq, fills = _pending_fills(ring_cls, mod, data)
        ring.resize(8 * 16 * 4, ring.total_span * 2)
        assert all(f.done for f in fills)
        with ring.open_earliest_sequence(guarantee=False) as rs:
            with rs.acquire(0, 24) as span:
                out[name] = np.array(span.data.as_numpy(), copy=True)
        seq.end()
        w.__exit__(None, None, None)
    assert np.array_equal(out['port'], data)
    assert np.array_equal(out['port'], out['jax'])


def test_concurrent_waits_complete_each_fill_once():
    """Readers, drains and the in-flight bound may race to complete the
    same fills: with 8 waiting threads and a draining one, under a short
    switch interval, each fill's host side runs once and every target
    gets its bytes; 8 threads shipping through one 2-slot pool each get
    their own values back."""
    import sys
    import threading
    from tests.test_torch_bounded import join_bounded
    rng = np.random.RandomState(15)
    datas = [rng.randn(32, 64).astype(np.float32) for _ in range(48)]
    outs = [np.zeros_like(d) for d in datas]
    eng = xfer.TransferEngine(depth=64, staging=2, zero_copy=False)
    fills = [eng.host_fill(eng.to_device(d), 'f32', o)
             for d, o in zip(datas, outs)]
    calls = [0] * len(fills)
    for i, f in enumerate(fills):
        finish = f.future._finish

        def counted(i=i, finish=finish):
            calls[i] += 1
            return finish()
        f.future._finish = counted
    bad = []

    def waiter(k):
        order = list(range(len(fills)))
        np.random.RandomState(k).shuffle(order)
        for i in order:
            fills[i].wait()

    def shipper(k):
        for j in range(40):
            a = np.full((64, 64), k * 1000 + j, np.float32)
            if not np.array_equal(eng.to_device(a).numpy(), a):
                bad.append((k, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=waiter, args=(k,))
                   for k in range(8)]
        threads += [threading.Thread(target=eng.drain)]
        threads += [threading.Thread(target=shipper, args=(k,))
                    for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            join_bounded(t)
    finally:
        sys.setswitchinterval(old)
    assert calls == [1] * len(fills)
    assert all(np.array_equal(o, d) for o, d in zip(outs, datas))
    assert not bad


# ---------------------------------------------------------------------------
# deferred D2H fills through the pipelines
# ---------------------------------------------------------------------------

class _Source(bt.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe):
        super(_Source, self).__init__(['numpy'], gulp_nframe,
                                      space='system')
        self._gulps = gulps
        self._header = header

    def create_reader(self, sourcename):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, sourcename):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        arr = next(reader, None)
        if arr is None:
            return [0]
        ospans[0].data.as_numpy()[:arr.shape[0]] = arr
        return [arr.shape[0]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.gulps = []

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self):
        return np.concatenate(self.gulps)


def _make_raw(nt=64, npol=2, nf=256, seed=7):
    rng = np.random.RandomState(seed)
    raw = np.zeros((nt, npol, nf), dtype=bf.dtype.ci8)
    raw['re'] = rng.randint(-64, 64, raw.shape)
    raw['im'] = rng.randint(-64, 64, raw.shape)
    return raw


def _hdr(raw):
    return simple_header([-1, raw.shape[1], raw.shape[2]], 'ci8',
                         labels=['time', 'pol', 'fine_time'])


def _run_chain(raw, ngulp=6, **scope):
    """The port's _run_chain (tests/test_xfer_async.py:213-233): ci8
    source -> copy('cuda') -> fused[FFT -> Stokes -> reduce(freq, 4)] ->
    copy('system') -> sink."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    with bt.Pipeline(**scope) as p:
        src = _Source([raw.copy() for _ in range(ngulp)], _hdr(raw),
                      raw.shape[0])
        b = bt.blocks.copy(src, space='cuda')
        fb = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', 4)])
        b2 = bt.blocks.copy(fb, space='system')
        sink = _Gather(b2)
        run_bounded(p)
    return sink.result(), b2


def _run_jax_chain(raw, ngulp=6, **scope):
    from bifrost_tpu.stages import FftStage, DetectStage, ReduceStage
    with bf.Pipeline(**scope) as p:
        src = NumpySourceBlock([raw.copy() for _ in range(ngulp)],
                               _hdr(raw), gulp_nframe=raw.shape[0])
        b = bf.blocks.copy(src, space='tpu')
        fb = bf.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', 4)])
        b2 = bf.blocks.copy(fb, space='system')
        sink = GatherSink(b2)
        run_bounded(p)
    return sink.result(), b2


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_async_d2h_fills_deliver_the_strict_bytes():
    """CopyBlock's deferred-fill D2H delivers the bytes of the
    synchronous path, actually runs async, and equals the JAX chain
    (:236)."""
    raw = _make_raw()
    out_async, _ = _run_chain(raw, ngulp=8, sync_depth=4)
    snap = counters.snapshot()
    assert snap.get('xfer.d2h_async', 0) >= 8
    assert snap.get('pipeline.sync_waits', 0) <= \
        snap.get('pipeline.gulps_device', 1) / 4.0 + 1
    want, _ = _run_jax_chain(raw, ngulp=8, sync_depth=4)
    _same('xfer.d2h_async', 'xfer.d2h_issued', 'xfer.d2h_bytes',
          'xfer.h2d_issued', 'xfer.h2d_bytes', 'pipeline.gulps_device')
    counters.reset()
    out_sync, _ = _run_chain(raw, ngulp=8, sync_depth=4, sync_strict=True)
    assert counters.get('xfer.d2h_async') == 0
    assert np.array_equal(out_async, out_sync)
    assert out_async.shape == want.shape
    assert _rel(out_async, want) < GATE


def test_sync_strict_fallback_is_synchronous():
    """sync_strict=True routes every D2H through the blocking path
    (:253)."""
    raw = _make_raw(seed=3)
    _run_chain(raw, ngulp=4, sync_strict=True)
    _run_jax_chain(raw, ngulp=4, sync_strict=True)
    assert counters.get('xfer.d2h_async') == 0
    _same('xfer.d2h_async', 'xfer.d2h_issued')


def test_strict_env_makes_the_pipeline_synchronous(monkeypatch):
    monkeypatch.setenv('BF_SYNC_STRICT', '1')
    raw = _make_raw(seed=4)
    out, _ = _run_chain(raw, ngulp=3)
    assert counters.get('xfer.d2h_async') == 0
    monkeypatch.delenv('BF_SYNC_STRICT')
    again, _ = _run_chain(raw, ngulp=3)
    assert np.array_equal(out, again)


def test_host_fill_wraparound_ghost():
    """Deferred fills landing in wrapped spans mirror the ghost overflow,
    so readers of the wrapped bytes see the data (:302)."""
    rng = np.random.RandomState(11)
    gulps = [rng.randn(8, 16).astype(np.float32) for _ in range(12)]
    hdr = simple_header([-1, 16], 'f32')
    with bt.Pipeline(buffer_nframe=20) as p:
        src = _Source(gulps, hdr, 8)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.copy(b, space='system')
        sink = _Gather(b)
        run_bounded(p)
    with bf.Pipeline(buffer_nframe=20) as jp:
        jsrc = NumpySourceBlock(gulps, hdr, gulp_nframe=8)
        jb = bf.blocks.copy(jsrc, space='tpu')
        jb = bf.blocks.copy(jb, space='system')
        jsink = GatherSink(jb)
        run_bounded(jp)
    assert np.array_equal(sink.result(), np.concatenate(gulps))
    assert np.array_equal(sink.result(), jsink.result())
    _same('xfer.d2h_issued', 'xfer.d2h_bytes', 'xfer.h2d_issued')


def test_xfer_result_fault_poisons_the_output_ring():
    """A D2H that fails at ``xfer.result`` poisons the ring its fill
    targets, and run() raises, in both packages."""
    raw = _make_raw(seed=5)
    with faults.injected('xfer.result', count=1, after=1) as f:
        with pytest.raises(bt.PipelineRuntimeError) as exc:
            _run_chain(raw, ngulp=4)
        assert f.fired == 1
    assert 'injected fault at xfer.result' in str(exc.value)
    with jfaults.injected('xfer.result', count=1, after=1) as jf:
        with pytest.raises(JPipelineRuntimeError):
            _run_jax_chain(raw, ngulp=4)
        assert jf.fired == 1
    _same('xfer.fill_errors', 'xfer.errors')
    assert counters.get('xfer.fill_errors') == 1
    assert counters.get('ring_poisoned') >= 1


def test_xfer_result_fault_poisons_the_fill_target():
    """The failed fill poisons exactly its target ring; a reader of that
    ring gets RingPoisonedError, as in the JAX ring."""
    from bifrost_tpu.ring import RingPoisonedError as JPoisoned
    from bifrost_tpu_torch.ring import RingPoisonedError
    data = np.random.RandomState(13).randn(24, 16).astype(np.float32)
    for ring_cls, mod, fm, poisoned in ((Ring, xfer, faults,
                                         RingPoisonedError),
                                        (JRing, jxfer, jfaults, JPoisoned)):
        ring, w, seq, fills = _pending_fills(ring_cls, mod, data)
        with fm.injected('xfer.result'):
            with ring.open_earliest_sequence(guarantee=False) as rs:
                with pytest.raises(fm.FaultInjected):
                    rs.acquire(0, 8)
        assert ring.poisoned and fills[0].error is not None
        with pytest.raises(fm.FaultInjected):
            fills[0].wait()
        with pytest.raises(poisoned):
            with ring.open_earliest_sequence(guarantee=False) as rs:
                rs.acquire(8, 8)


def test_bf_faults_env_arms_the_pipeline(monkeypatch):
    """BF_FAULTS reaches the transfer seams through Pipeline.run."""
    monkeypatch.setenv('BF_FAULTS', 'xfer.h2d::1:2')
    raw = _make_raw(seed=6)
    with pytest.raises(bt.PipelineRuntimeError) as exc:
        _run_chain(raw, ngulp=4)
    assert 'xfer.h2d' in str(exc.value)
    assert faults.fired('xfer.h2d') == 1
