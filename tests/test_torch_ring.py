"""Ring semantics of the PyTorch/CUDA port (bifrost_tpu_torch.ring), on
both storages: host ('system': numpy byte buffer with a ghost region)
and device ('cuda': chunk map of tensors, on the CPU device here).  The
cases are those tests/test_ring_python_core.py runs against the JAX
package's Python core, parametrised over the storage."""

import threading
import time

import numpy as np
import pytest
import torch

from bifrost_tpu_torch import device
from bifrost_tpu_torch.ring import Ring, WouldBlock

from tests.test_torch_bounded import join_bounded

SPACES = ['system', 'cuda']


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _hdr(frame_shape=(4,), dtype='f32', name='test', shape=None,
         labels=None):
    shape = list(shape) if shape is not None else [-1] + list(frame_shape)
    n = len(shape)
    return {'name': name, 'time_tag': 0,
            '_tensor': {'shape': shape, 'dtype': dtype,
                        'labels': labels or
                        ['time'] + ['dim%d' % i for i in range(1, n)],
                        'scales': [[0, 1]] * n, 'units': [None] * n}}


def _put(span, value):
    """Fill a write span with ``value`` (an array of the span's shape,
    or a scalar)."""
    shape = span.shape
    arr = np.broadcast_to(np.asarray(value, np.float32), shape)
    if span.ring.is_device:
        span.set(torch.from_numpy(np.array(arr)))
    else:
        span.data.as_numpy()[...] = arr


def _get(span):
    if span.ring.is_device:
        return span.data.numpy().copy()
    return np.array(span.data.as_numpy(), copy=True)


def _run_writer(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t


@pytest.mark.parametrize('space', SPACES)
def test_write_read_simple(space):
    ring = Ring(space=space)
    hdr = _hdr()
    received = []

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=8,
                                   buf_nframe=24) as seq:
                for k in range(4):
                    with seq.reserve(8) as span:
                        _put(span, np.arange(32).reshape(8, 4) + 100 * k)
                        span.commit(8)

    t = _run_writer(writer)
    for seq in ring.read(guarantee=True):
        seq.resize(gulp_nframe=8)
        for span in seq.read(8):
            received.append(_get(span))
    join_bounded(t)
    assert len(received) == 4
    np.testing.assert_array_equal(received[2],
                                  np.arange(32).reshape(8, 4) + 200)


@pytest.mark.parametrize('space', SPACES)
def test_partial_final_span(space):
    ring = Ring(space=space)
    hdr = _hdr(frame_shape=(2,))

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=8,
                                   buf_nframe=24) as seq:
                with seq.reserve(8) as span:
                    _put(span, 1.0)
                    span.commit(8)
                with seq.reserve(8) as span:
                    _put(span, 2.0)
                    span.commit(3)   # partial final gulp

    t = _run_writer(writer)
    sizes, last = [], None
    for seq in ring.read():
        seq.resize(gulp_nframe=8)
        for span in seq.read(8):
            sizes.append(span.nframe)
            last = _get(span)
    join_bounded(t)
    assert sizes == [8, 3]
    np.testing.assert_array_equal(last, np.full((3, 2), 2.0, np.float32))


@pytest.mark.parametrize('space', SPACES)
def test_multiple_sequences(space):
    ring = Ring(space=space)

    def writer():
        with ring.begin_writing() as wr:
            for s in range(3):
                hdr = _hdr(name='seq%d' % s)
                hdr['time_tag'] = s
                with wr.begin_sequence(hdr, gulp_nframe=4,
                                       buf_nframe=12) as seq:
                    with seq.reserve(4) as span:
                        _put(span, s)
                        span.commit(4)

    t = _run_writer(writer)
    names = []
    for seq in ring.read():
        seq.resize(gulp_nframe=4)
        for span in seq.read(4):
            names.append((seq.header['name'], float(_get(span).ravel()[0])))
    join_bounded(t)
    assert names == [('seq0', 0.0), ('seq1', 1.0), ('seq2', 2.0)]


@pytest.mark.parametrize('space', SPACES)
def test_overlap_read(space):
    """Overlapped gulps (stride < nframe): on device storage each span
    after the first is stitched from two committed chunks."""
    ring = Ring(space=space)
    hdr = _hdr(frame_shape=(1,))

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=6,
                                   buf_nframe=32) as seq:
                for k in range(3):
                    with seq.reserve(6) as span:
                        _put(span, (np.arange(6) + 6 * k)[:, None])
                        span.commit(6)

    t = _run_writer(writer)
    got = []
    for seq in ring.read():
        seq.resize(gulp_nframe=8, buffer_factor=4)
        for span in seq.read(8, stride=6):
            got.append(_get(span)[:, 0])
    join_bounded(t)
    np.testing.assert_array_equal(got[0], np.arange(8))
    np.testing.assert_array_equal(got[1], np.arange(6, 14))
    # the last span runs into the end of the sequence
    np.testing.assert_array_equal(got[2], np.arange(12, 18))


def test_device_exact_cover_returns_committed_tensor():
    """A read span that a committed chunk covers exactly hands out that
    tensor itself (no copy); one that straddles two chunks is stitched,
    with zeros where no chunk holds the frames."""
    ring = Ring(space='cuda')
    hdr = _hdr(frame_shape=(2,))
    with ring.begin_writing() as wr:
        with wr.begin_sequence(hdr, gulp_nframe=4, buf_nframe=16) as seq:
            tensors = []
            for k in range(2):
                with seq.reserve(4) as span:
                    x = torch.full((4, 2), float(k + 1))
                    tensors.append(x)
                    span.set(x)
                    span.commit(4)
            with ring.open_earliest_sequence() as rseq:
                with rseq.acquire(0, 4) as span:
                    assert span.data is tensors[0]
                with rseq.acquire(2, 4) as span:
                    np.testing.assert_array_equal(
                        span.data.numpy()[:, 0], [1, 1, 2, 2])
                storage = ring._storage
                # frames 8..12 were never written: zero-filled stitch
                got = storage.get(4 * 8, 8 * 8, 8,
                                  lambda n: torch.zeros((n, 2)))
                np.testing.assert_array_equal(got.numpy()[:, 0],
                                              [2, 2, 2, 2, 0, 0, 0, 0])


def test_device_span_rejects_wrong_shape():
    ring = Ring(space='cuda')
    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=4,
                               buf_nframe=8) as seq:
            with seq.reserve(4) as span:
                with pytest.raises(ValueError):
                    span.set(torch.zeros((4, 5)))


@pytest.mark.parametrize('space', SPACES)
def test_ringlets(space):
    ring = Ring(space=space)
    hdr = _hdr(shape=[2, -1, 3], labels=['beam', 'time', 'chan'])

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=4,
                                   buf_nframe=12) as seq:
                with seq.reserve(4) as span:
                    assert tuple(span.shape) == (2, 4, 3)
                    d = np.zeros((2, 4, 3), np.float32)
                    d[0], d[1] = 1.0, 2.0
                    _put(span, d)
                    span.commit(4)

    t = _run_writer(writer)
    for seq in ring.read():
        seq.resize(gulp_nframe=4)
        for span in seq.read(4):
            d = _get(span)
            assert d.shape == (2, 4, 3)
            assert np.all(d[0] == 1.0) and np.all(d[1] == 2.0)
    join_bounded(t)


def test_host_ghost_region_wrap():
    """A gulp that straddles the nominal end of a host ring stays one
    contiguous span: the write is mirrored out of the ghost region to
    the buffer start, and the read refreshes the ghost from it."""
    ring = Ring(space='system')
    hdr = _hdr(frame_shape=(1,))
    got = []
    attached = threading.Event()

    def writer():
        with ring.begin_writing() as wr:
            # 6-frame gulps in a 16-frame ring: the third gulp wraps
            with wr.begin_sequence(hdr, gulp_nframe=6,
                                   buf_nframe=16) as seq:
                for k in range(5):
                    if k == 1:
                        assert attached.wait(10)
                    with seq.reserve(6) as span:
                        _put(span, (np.arange(6) + 6 * k)[:, None])
                        span.commit(6)

    t = _run_writer(writer)
    for seq in ring.read(guarantee=True):
        attached.set()
        for span in seq.read(6):
            got.append(_get(span)[:, 0])
    join_bounded(t)
    assert ring.total_span == 16 * 4
    np.testing.assert_array_equal(np.concatenate(got), np.arange(30))


@pytest.mark.parametrize('space', SPACES)
def test_unguaranteed_overwrite_skip(space):
    """A slow unguaranteed reader gets frames skipped, not a deadlock."""
    ring = Ring(space=space)
    hdr = _hdr(frame_shape=(1,))
    start_reading = threading.Event()

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=4,
                                   buf_nframe=8) as seq:
                for k in range(16):
                    with seq.reserve(4) as span:
                        _put(span, k)
                        span.commit(4)
                    if k == 0:
                        start_reading.set()

    t = _run_writer(writer)
    start_reading.wait()
    join_bounded(t)     # let the writer lap the reader completely
    skipped_total = frames = 0
    for seq in ring.read(guarantee=False):
        seq.resize(gulp_nframe=4, buffer_factor=2)
        for span in seq.read(4):
            skipped_total += span.nframe_skipped
            frames += span.nframe
    assert skipped_total > 0
    assert frames + skipped_total == 64


@pytest.mark.parametrize('space', SPACES)
def test_resize_while_data_buffered(space):
    ring = Ring(space=space)
    hdr = _hdr(frame_shape=(2,))
    with ring.begin_writing() as wr:
        with wr.begin_sequence(hdr, gulp_nframe=4, buf_nframe=12) as seq:
            with seq.reserve(4) as span:
                _put(span, 7.0)
                span.commit(4)
            ring.resize(4 * 8, 64 * 8)      # grow with data buffered
            with seq.reserve(4) as span:
                _put(span, 9.0)
                span.commit(4)
    vals = []
    for seq in ring.read():
        for span in seq.read(4):
            vals.append(float(_get(span).ravel()[0]))
    assert vals == [7.0, 9.0]


@pytest.mark.parametrize('space', SPACES)
def test_partial_commit_with_outstanding_spans_is_clean_error(space):
    """A partial commit is legal only on the newest outstanding span,
    and the error leaves the ring state untouched."""
    ring = Ring(space=space)
    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=8,
                               buf_nframe=32) as seq:
            s1 = seq.reserve(8)
            s2 = seq.reserve(8)
            _put(s1, 1.0)
            _put(s2, 2.0)
            s1.commit(4)
            with pytest.raises(RuntimeError):
                s1.close()
            s1.commit(8)
            s1.close()
            s2.commit(8)
            s2.close()
            done = threading.Event()

            def do_resize():
                ring.resize(16 * 16, 64 * 16)
                done.set()

            threading.Thread(target=do_resize, daemon=True).start()
            assert done.wait(10), "resize deadlocked: nwrite_open leaked"


@pytest.mark.parametrize('space', SPACES)
def test_partial_commit_on_newest_span_ok(space):
    ring = Ring(space=space)

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(_hdr(), gulp_nframe=8,
                                   buf_nframe=32) as seq:
                with seq.reserve(8) as span:
                    _put(span, 5.0)
                    span.commit(3)

    t = _run_writer(writer)
    got = []
    for seq in ring.read(guarantee=True):
        seq.resize(gulp_nframe=8)
        for span in seq.read(8):
            got.append(_get(span).shape[0])
    join_bounded(t)
    assert got == [3]


@pytest.mark.parametrize('space', SPACES)
def test_reserve_after_partial_commit_rejected(space):
    ring = Ring(space=space)
    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=8,
                               buf_nframe=32) as seq:
            s1 = seq.reserve(8)
            s2 = seq.reserve(8)
            s2.commit(4)
            s2.close()              # queued partial (s1 still open)
            with pytest.raises(RuntimeError):
                seq.reserve(8)
            s1.commit(8)
            s1.close()


@pytest.mark.parametrize('space', SPACES)
def test_multi_open_spans_pin_guarantee(space):
    """A guaranteed reader holding several open spans pins the guarantee
    at the oldest: the writer must not overwrite a held span."""
    ring = Ring(space=space)
    wrote, reader_ready, done = (threading.Event() for _ in range(3))

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(_hdr(), gulp_nframe=8,
                                   buf_nframe=32) as seq:
                for k in range(12):
                    with seq.reserve(8) as span:
                        _put(span, float(k))
                        span.commit(8)
                    if k == 3:
                        wrote.set()
                        assert reader_ready.wait(10)
        done.set()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    with ring.open_earliest_sequence(guarantee=True) as rseq:
        assert wrote.wait(10)
        spans = [rseq.acquire(k * 8, 8) for k in range(3)]
        reader_ready.set()
        assert not done.wait(0.3), \
            "writer lapped the ring over held read spans"
        for k, span in enumerate(spans):
            np.testing.assert_array_equal(
                _get(span), np.full((8, 4), float(k), np.float32))
        for span in spans:
            span.release()
    assert done.wait(10), "writer still blocked after release"
    t.join(5)


@pytest.mark.parametrize('space', SPACES)
def test_open_span_survives_later_acquires(space):
    ring = Ring(space=space)
    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=4,
                               buf_nframe=16) as seq:
            for k in range(4):
                with seq.reserve(4) as span:
                    _put(span, float(k))
                    span.commit(4)
            with ring.open_earliest_sequence(guarantee=True) as rseq:
                first = rseq.acquire(0, 4)
                later = rseq.acquire(8, 4)
                with pytest.raises(WouldBlock):
                    seq.reserve(4, nonblocking=True)
                first.release()
                with seq.reserve(4, nonblocking=True) as span:
                    span.commit(0)
                later.release()


@pytest.mark.parametrize('space', SPACES)
def test_out_of_order_span_release_frees_writer(space):
    ring = Ring(space=space)
    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=4,
                               buf_nframe=16) as seq:
            for k in range(4):
                with seq.reserve(4) as span:
                    _put(span, float(k))
                    span.commit(4)
            with ring.open_earliest_sequence(guarantee=True) as rseq:
                first = rseq.acquire(0, 4)
                later = rseq.acquire(8, 4)
                later.release()          # newest first
                first.release()
                with seq.reserve(4, nonblocking=True) as span:
                    _put(span, 4.0)
                    span.commit(4)
                with seq.reserve(4, nonblocking=True) as span:
                    span.commit(0)


@pytest.mark.parametrize('space', SPACES)
def test_stress_concurrent_churn(space):
    """Many small gulps through a small ring with a guaranteed reader,
    under a short thread switch interval: wrap-around, ghost copies
    (host) or chunk discard (device) and flow control must lose,
    duplicate or reorder no frame."""
    import sys
    ring = Ring(space=space)
    hdr = _hdr(frame_shape=(16,))
    ngulp, gulp = 200, 8
    rng = np.random.RandomState(42)
    sent = rng.randint(0, 255, size=(ngulp, gulp, 16)).astype(np.float32)
    attached = threading.Event()

    def writer():
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=gulp,
                                   buf_nframe=gulp * 3) as seq:
                for k in range(ngulp):
                    if k == 1:
                        assert attached.wait(30)
                    with seq.reserve(gulp) as span:
                        _put(span, sent[k])
                        span.commit(gulp)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        got = []
        for seq in ring.read(guarantee=True):
            attached.set()
            seq.resize(gulp_nframe=gulp)
            for span in seq.read(gulp):
                got.append(_get(span))
        t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.stack(got), sent)


def test_device_lookup_sees_no_concurrent_discard():
    """An overlapped read stitches two committed chunks while the writer
    puts and discards chunks under the ring's lock.  The lookup takes the
    same lock, so a chunk the reader's guarantee still holds is never
    skipped and zero-filled (it was, about one read in three, when the
    lookup ran unlocked beside a discard)."""
    import sys
    from bifrost_tpu_torch.ring import _DeviceStorage
    lock = threading.RLock()
    cond = threading.Condition(lock)
    store = _DeviceStorage(lock)
    frame, chunk = 4, 32                       # 8 frames per chunk
    for k in range(3):
        store.put(k * chunk, chunk, torch.full((8,), k + 1.), 0, None)
    state = {'k': 3, 'guard': 0, 'stop': False, 'bad': 0, 'reads': 0}

    def writer():
        while not state['stop']:
            with cond:
                while state['k'] >= state['guard'] // chunk + 6 and \
                        not state['stop']:
                    cond.wait(0.01)
                k = state['k']
                store.put(k * chunk, chunk, torch.full((8,), k + 1.), 0,
                          None)
                store.discard_before(min((k - 2) * chunk, state['guard']))
                state['k'] = k + 1

    def reader():
        while not state['stop']:
            with cond:
                k = state['k']
                state['guard'] = (k - 2) * chunk     # the read guarantee
                cond.notify_all()
            x = store.get((k - 2) * chunk + 4 * frame, chunk, frame,
                          torch.zeros)
            state['reads'] += 1
            state['bad'] += int(bool((x == 0).any()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f, daemon=True)
                   for f in (writer, reader)]
        for t in threads:
            t.start()
        deadline = time.time() + 0.5
        while time.time() < deadline:
            time.sleep(0.01)
        state['stop'] = True
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert state['reads'] > 100 and state['bad'] == 0


def test_poison_wakes_blocked_reader():
    from bifrost_tpu_torch.ring import RingPoisonedError
    ring = Ring(space='cuda')
    errors = []

    def reader():
        try:
            for seq in ring.read():
                for _span in seq.read(4):
                    pass
        except RingPoisonedError as e:
            errors.append(e)

    with ring.begin_writing() as wr:
        with wr.begin_sequence(_hdr(), gulp_nframe=4, buf_nframe=8):
            t = threading.Thread(target=reader, daemon=True)
            t.start()
            ring.poison(ValueError('upstream failed'))
            t.join(10)
    assert not t.is_alive() and len(errors) == 1
