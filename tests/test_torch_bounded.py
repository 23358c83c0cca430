"""A bounded ``Pipeline.run`` for the port's tests, and its own tests.

A deadlock in a ring or pipeline presents as a hang, not an error: an
unbounded ``p.run()`` would then stall its test worker, and with it the
rest of the suite.  :func:`run_bounded` runs the pipeline on a daemon
thread, re-raises the run's own exception (so ``pytest.raises`` around it
keeps its meaning) and fails the test after ``timeout`` seconds with
every thread's stack (``faulthandler.dump_traceback``) in the failure
message.
"""

import faulthandler
import tempfile
import threading

import numpy as np
import pytest

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device

#: seconds a test's pipeline may run before the test fails
RUN_TIMEOUT = 60.


def thread_stacks():
    """Every thread's stack, as ``faulthandler.dump_traceback`` writes
    it."""
    with tempfile.TemporaryFile(mode='w+') as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


def run_bounded(pipeline, timeout=RUN_TIMEOUT):
    """``pipeline.run()`` on a daemon thread, waited for at most
    ``timeout`` seconds.  Re-raises the run's exception; on time-out
    shuts the pipeline down and fails the test with every thread's
    stack."""
    box = {}

    def target():
        try:
            pipeline.run()
        except BaseException as exc:
            box['exc'] = exc

    t = threading.Thread(target=target, daemon=True,
                         name='run_bounded(%s)' % getattr(pipeline, 'name',
                                                          'pipeline'))
    t.start()
    t.join(timeout)
    if t.is_alive():
        stacks = thread_stacks()
        pipeline.shutdown()
        pytest.fail('pipeline still running after %g s; every thread:\n%s'
                    % (timeout, stacks), pytrace=False)
    if 'exc' in box:
        raise box['exc']


def join_bounded(thread, timeout=RUN_TIMEOUT):
    """``thread.join(timeout)``, failing the test with every thread's
    stack if the thread is still alive."""
    thread.join(timeout)
    if thread.is_alive():
        pytest.fail('thread %s still running after %g s; every thread:\n%s'
                    % (thread.name, timeout, thread_stacks()),
                    pytrace=False)


# ---------------------------------------------------------------------------
# the helper's own tests
# ---------------------------------------------------------------------------

class _Source(bt.SourceBlock):
    def __init__(self, n):
        super(_Source, self).__init__(['src'], 4)
        self.n = n

    def create_reader(self, name):
        import contextlib
        return contextlib.nullcontext()

    def on_sequence(self, reader, name):
        return [{'name': 'x', '_tensor': {
            'shape': [-1, 3], 'dtype': 'f32', 'labels': ['time', 'x'],
            'scales': [[0, 1], [0, 1]], 'units': [None, None]}}]

    def on_data(self, reader, ospans):
        if self.n == 0:
            return [0]
        self.n -= 1
        ospans[0].data.as_numpy()[...] = self.n
        return [4]


class _Sink(bt.SinkBlock):
    def __init__(self, iring, fail=False):
        super(_Sink, self).__init__(iring)
        self.fail = fail
        self.seen = []

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        if self.fail:
            raise ValueError('sink failed')
        self.seen.append(np.array(ispan.data.as_numpy()))


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def test_run_bounded_runs_the_pipeline():
    with bt.Pipeline() as p:
        sink = _Sink(_Source(3))
    run_bounded(p, timeout=30)
    assert [int(g[0, 0]) for g in sink.seen] == [2, 1, 0]


def test_run_bounded_reraises_the_runs_exception():
    with bt.Pipeline() as p:
        _Sink(_Source(2), fail=True)
    with pytest.raises(bt.PipelineRuntimeError, match='sink failed'):
        run_bounded(p, timeout=30)


def test_run_bounded_fails_a_hung_run_with_every_stack():
    """A run that never ends fails the test after the bound, naming the
    stuck thread's frames, and is shut down."""
    class _Hung(object):
        name = 'hung'

        def __init__(self):
            self.release = threading.Event()

        def run(self):
            self.release.wait()

        def shutdown(self):
            self.release.set()

    hung = _Hung()
    with pytest.raises(pytest.fail.Exception) as info:
        run_bounded(hung, timeout=0.5)
    msg = str(info.value)
    assert 'still running after 0.5 s' in msg
    assert 'in run' in msg and 'Thread' in msg
    assert hung.release.is_set()


def test_join_bounded_fails_a_thread_that_does_not_end():
    release = threading.Event()
    t = threading.Thread(target=release.wait, daemon=True, name='stuck')
    t.start()
    with pytest.raises(pytest.fail.Exception, match='stuck still running'):
        join_bounded(t, timeout=0.2)
    release.set()
    join_bounded(t, timeout=10)
