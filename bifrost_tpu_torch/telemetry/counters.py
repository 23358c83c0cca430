"""In-process performance counters for the transfer engine, the ring and
the pipeline gulp loop (the JAX package's
``bifrost_tpu/telemetry/counters.py``, same API and the same names).

Always-on, process-local integers with no persistence and no I/O: the
hot paths increment them under a lock, and tests, ``chip_smoke.py`` and
operators read a snapshot.

Counter names used by the port:

- ``xfer.h2d_issued`` / ``xfer.h2d_bytes``  host->device transfers
- ``xfer.h2d_staged``                      H2D through a reused pinned
                                           staging slot
- ``xfer.h2d_unstaged``                    H2D through a fresh buffer
                                           (small gulp, strict mode, or
                                           every slot of its key busy)
- ``xfer.h2d_direct``                      H2D straight from a pinned
                                           ``cuda_host`` span, no copy
- ``xfer.h2d_batched``                     host gulps shipped through
                                           ``to_device_batch``
- ``xfer.d2h_issued`` / ``xfer.d2h_bytes``  device->host transfers
- ``xfer.d2h_async``                       D2H issued non-blocking (the
                                           future / fill queue)
- ``xfer.d2h_staged``                      D2H into a pinned slot, then
                                           one host copy into the target
- ``xfer.d2h_direct``                      D2H straight into a pinned
                                           target (a ``cuda_host`` span)
- ``xfer.sync_waits``                      hard host waits inside a
                                           transfer (result not ready)
- ``xfer.depth_waits``                     waits forced by the in-flight
                                           bound before the transfer
                                           finished on its own
- ``xfer.errors`` / ``xfer.fill_errors``    failed D2H transfers /
                                           deferred ring fills
- ``ring_poisoned``                        rings marked dead by
                                           ``Ring.poison``
- ``pipeline.gulps``                       gulps through
                                           ``Block._sync_gulp``
- ``pipeline.gulps_device``                those that committed device
                                           tensors
- ``pipeline.sync_waits``                  run-ahead drain waits in
                                           ``Block._sync_gulp``
- ``block.<name>.dispatches`` /
  ``block.<name>.gulps``                   ``on_data`` dispatches of a
                                           block and the logical gulps
                                           they covered (K a dispatch
                                           under macro-gulp execution;
                                           a segment's members count
                                           gulps, the segment dispatches)
- ``macro.fallback.<reason>``              sequences a block ran at K = 1
                                           although a batch was asked
                                           (block, topology,
                                           unguaranteed, overlap,
                                           dynamic_gulp, nonlinear), and
                                           ``multi_reader_retired``: ones
                                           that batched on a ring with
                                           several readers
- ``segment.compiled`` /
  ``segment.elided_rings`` /
  ``segment.overlap_carried``              segments made, interior rings
                                           elided, overlap boundaries
                                           carried inside a segment
- ``segment.dispatches`` /
  ``segment.gulps``                        calls of compiled segments and
                                           the logical gulps they covered
- ``donation.hits`` / ``donation.misses``  input chunks claimed out of
                                           their ring for donation /
                                           donating reads that read the
                                           ring instead
- ``fused.plan_builds``                    FusedBlock (and segment) plans
                                           built
- ``trace.dropped_spans``                  spans evicted by per-thread
                                           span-buffer overflow (added by
                                           ``telemetry.snapshot()``)
Ring-bridge counters (``io/bridge.py``, wire v2):

- ``bridge.tx.frames`` / ``bridge.tx.bytes`` /
  ``bridge.tx.spans``                      frames, payload bytes and span
                                           frames sent by RingSender
- ``bridge.tx.reconnects``                 sender redials (unacked frames
                                           retransmitted)
- ``bridge.redial_attempts``               redials tried, and
  ``bridge.circuit_open``                  redial budgets spent
- ``bridge.tx.restripes``                  planned stripe-count retunes
                                           (drained redials at a span
                                           boundary, not counted against
                                           the reconnect budget)
- ``bridge.tx.shed_gulps`` /
  ``bridge.tx.shed_bytes`` /
  ``bridge.tx.quota_shed_gulps``           gulps and bytes the sender
                                           shed at the credit window or
                                           its per-stream quota
- ``bridge.rx.frames`` / ``bridge.rx.bytes`` /
  ``bridge.rx.spans``                      frames, bytes and spans
                                           committed by RingReceiver
- ``bridge.rx.dups``                       retransmitted frames dropped
                                           by sequence number after a
                                           reconnect
- ``bridge.rx.crc_errors``                 span CRC32 mismatches
                                           (``BF_BRIDGE_CRC=1``); each
                                           raises BridgeProtocolError
- ``bridge.rx.sessions_adopted``           new sender sessions a receiver
                                           with ``adopt_sessions`` took

The send-stall and recv-wait distributions are the
``bridge.<name>.send_stall_s`` / ``bridge.<name>.recv_wait_s``
histograms; each endpoint's byte totals and rate are on the
``<name>_bridge_transmit/stats`` / ``<name>_bridge_capture/stats``
ProcLogs.  The health monitor reads the reconnect, redial, circuit and
shed counters as degraded-mode events.
"""

from __future__ import annotations

import threading
from collections import defaultdict

__all__ = ['inc', 'get', 'snapshot', 'reset']

_lock = threading.Lock()
_counts = defaultdict(int)


def inc(name, n=1):
    """Add ``n`` to counter ``name`` (thread-safe)."""
    with _lock:
        _counts[name] += n


def get(name):
    """Current value of counter ``name`` (0 if never incremented)."""
    with _lock:
        return _counts.get(name, 0)


def snapshot():
    """Copy of all counters as a plain dict."""
    with _lock:
        return dict(_counts)


def reset():
    """Zero all counters (tests/benchmarks)."""
    with _lock:
        _counts.clear()
