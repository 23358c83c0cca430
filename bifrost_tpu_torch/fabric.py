"""The multi-host fabric (the counterpart of ``bifrost_tpu/fabric.py``;
same spec format, wire, heartbeats, ledgers and counters, so hosts of
either package join one fabric).

The ring bridge (:mod:`bifrost_tpu_torch.io.bridge`) is the pipe
between two rings; this module composes many of them into a deployable
fabric:

- **Declarative topology** (:class:`FabricSpec`): the hosts (address,
  control port, core pins) and the named links between them:
  point-to-point pipes, N-origin fan-in and sequence-striped fan-out.
  JSON round-trippable (``python -m bifrost_tpu_torch.tools.bf_fabric``
  lints, launches and inspects specs) and statically checked
  (``analysis.verify.verify_fabric``: BF-E200/E201/W202/W203).
- **Launcher** (:class:`FabricHost`): builds one host's sub-pipeline
  from the spec (a session-adopting BridgeSource per inbound endpoint, a
  :class:`FanInBlock` merging N origins, the builder's processing chain,
  a BridgeSink or :class:`FanOutBlock` per outbound link) and runs it
  under the supervision layer, with the spec's core pins, the ProcLog
  host identity, a clean drain on SIGTERM and a jittered rejoin.  The
  bridge carries host rings: a host that feeds the card reads its
  link into a ``system`` or ``cuda_host`` ring and copies to ``cuda``.
- **Fan-out** (:class:`FanOutBlock`): one ring to N downstream hosts,
  sequence ``i`` on leg ``i mod N``.  A dead leg (by membership) makes
  a counted re-stripe across the survivors
  (``fabric.fanout.restripes``); a leg that stalls without dying sheds
  at its leg ring (``drop_oldest``, the byte-exact shed ledger) instead
  of wedging the fan.
- **Fan-in** (:class:`FanInBlock`): N origins into one ring,
  interleaved by sequence and tagged per origin (the ``_fabric`` header
  block: origin, origin sequence ordinal, link).  A dead origin is
  marked GAPPED through the ``_overload`` stamp (``fabric.fanin.gapped``)
  and skipped, never stalled on; when it rejoins, its stream goes on as
  a tagged continuation.
- **Whole-host failure**: UDP heartbeats over the spec's control ports
  (:class:`Membership`) feed a fabric health state rolled up from the
  local pipeline's health and peer liveness (``fabric/health`` ProcLog,
  ``FabricHost.health()``).  A SIGKILLed host's peers mark it dead
  within ``BF_FABRIC_DEADLINE_SECS``; its relaunched process rejoins
  with a jittered start (``BF_FABRIC_REJOIN_CAP``), a resume probe to
  each downstream endpoint (``io.bridge.query_resume``, the receiver's
  committed-frame frontier) and a replay of only the unacked frames
  through the bridge's resume protocol (``bridge.rx.sessions_adopted``).
  The :class:`AckLedger` journals delivered and shed bytes under
  ``BF_FABRIC_STATE`` (default ``~/.bifrost_tpu_torch/fabric``), so
  produced == delivered + shed holds byte for byte across a kill.
"""

from __future__ import annotations

import json
import os
import random
import socket as socket_mod
import threading
import time
from queue import Queue, Empty, Full

import numpy as np

from .pipeline import Block, Pipeline
from .proclog import ProcLog, set_identity
from .ring import RingPoisonedError
from .supervision import HEALTH_STATES, _env_float
from .telemetry import counters, histograms

__all__ = ['HostSpec', 'LinkSpec', 'FabricSpec', 'FabricSpecError',
           'Membership', 'AckLedger', 'FanOutBlock', 'FanInBlock',
           'FabricHost', 'FabricHostContext', 'apply_affinity',
           'fabric_state_dir']

#: header key carrying per-origin fabric tagging (origin host, origin
#: sequence ordinal, link name, stripe index, continuation flag)
FABRIC_HEADER_KEY = '_fabric'

_SEV = {s: i for i, s in enumerate(HEALTH_STATES)}


def _hb_secs():
    """Heartbeat period: ``BF_FABRIC_HEARTBEAT_SECS`` (default 0.2)."""
    return max(_env_float('BF_FABRIC_HEARTBEAT_SECS', 0.2), 0.02)


def _deadline_secs():
    """Peer silence before it is declared dead:
    ``BF_FABRIC_DEADLINE_SECS`` (default 1.5)."""
    return max(_env_float('BF_FABRIC_DEADLINE_SECS', 1.5), 0.1)


def _gap_secs():
    """Fan-in mid-sequence silence before the origin is marked gapped
    when membership cannot rule: ``BF_FABRIC_GAP_SECS``
    (default 1.0)."""
    return max(_env_float('BF_FABRIC_GAP_SECS', 1.0), 0.05)


def _rejoin_cap():
    """Cap of the jittered rejoin delay: ``BF_FABRIC_REJOIN_CAP``
    seconds (default 2.0; 0 disables the jitter)."""
    return max(_env_float('BF_FABRIC_REJOIN_CAP', 2.0), 0.0)


def fabric_state_dir():
    """Durable fabric state directory (``BF_FABRIC_STATE``, default
    ``~/.bifrost_tpu_torch/fabric``, beside the port's other state): ack
    and shed ledgers live here so loss accounting and resume frontiers
    survive a SIGKILLed launcher.  A JAX host and a port host share
    ledgers only through an explicit ``BF_FABRIC_STATE``."""
    base = os.environ.get('BF_FABRIC_STATE', '').strip()
    if not base:
        base = os.path.join(os.path.expanduser('~'), '.bifrost_tpu_torch',
                            'fabric')
    return base


class FabricSpecError(ValueError):
    """A fabric spec is structurally unusable (unknown host, malformed
    link).  Softer misconfigurations surface as BF-E2xx/W2xx
    diagnostics from ``analysis.verify.verify_fabric`` instead."""


class HostSpec(object):
    """One fabric host: where it is reachable, its control port, and
    its resource pins."""

    __slots__ = ('name', 'address', 'control_port', 'cores', 'role',
                 'bind_address')

    def __init__(self, name, address='127.0.0.1', control_port=0,
                 cores=None, role='worker', bind_address='0.0.0.0'):
        self.name = str(name)
        self.address = str(address)
        self.control_port = int(control_port or 0)
        self.cores = list(cores) if cores else None
        self.role = str(role or 'worker')
        self.bind_address = str(bind_address or '0.0.0.0')

    def as_dict(self):
        d = {'address': self.address,
             'control_port': self.control_port, 'role': self.role}
        if self.cores:
            d['cores'] = list(self.cores)
        if self.bind_address != '0.0.0.0':
            d['bind_address'] = self.bind_address
        return d


class LinkSpec(object):
    """One named link: a point-to-point ``pipe``, an N-origin
    ``fanin``, or a sequence-striped ``fanout``.  ``port`` is the BASE
    port: endpoint ``i`` of a fan listens on ``port + i`` (each on its
    own host; on loopback fabrics the offset keeps them distinct).
    ``connect`` optionally overrides the dial target per receiving
    host (``{host: [address, port]}``) — NAT holes and the chaos
    harness's fault-injecting proxy both ride this."""

    __slots__ = ('name', 'kind', 'src', 'dst', 'port', 'window',
                 'streams', 'crc', 'overload_policy', 'quota_mbps',
                 'quota_gulps', 'gulp_nbyte', 'buffer_spans', 'connect')

    KINDS = ('pipe', 'fanin', 'fanout')

    def __init__(self, name, kind, src, dst, port, window=None,
                 streams=None, crc=None, overload_policy=None,
                 quota_mbps=0.0, quota_gulps=0.0, gulp_nbyte=None,
                 buffer_spans=None, connect=None):
        self.name = str(name)
        self.kind = str(kind)
        if self.kind not in self.KINDS:
            raise FabricSpecError(
                "link %r: unknown kind %r (expected one of %s)"
                % (name, kind, ', '.join(self.KINDS)))
        self.src = list(src) if isinstance(src, (list, tuple)) \
            else [str(src)]
        self.dst = list(dst) if isinstance(dst, (list, tuple)) \
            else [str(dst)]
        self.port = int(port)
        self.window = None if window is None else max(int(window), 0)
        self.streams = None if streams is None else int(streams)
        self.crc = crc
        self.overload_policy = overload_policy
        self.quota_mbps = float(quota_mbps or 0.0)
        self.quota_gulps = float(quota_gulps or 0.0)
        self.gulp_nbyte = None if gulp_nbyte is None else int(gulp_nbyte)
        self.buffer_spans = None if buffer_spans is None \
            else int(buffer_spans)
        self.connect = dict(connect or {})

    # -- endpoint arithmetic ----------------------------------------------
    def origins(self):
        """Sending endpoints: [(host, index)] — fan-in origins carry
        their port offset."""
        return [(h, i) for i, h in enumerate(self.src)]

    def receivers(self):
        """Listening endpoints: [(host, port_offset)]."""
        if self.kind == 'fanin':
            # one dedicated receiver per origin, all on the dst host
            return [(self.dst[0], i) for i in range(len(self.src))]
        if self.kind == 'fanout':
            return [(h, j) for j, h in enumerate(self.dst)]
        return [(self.dst[0], 0)]

    def dial_target(self, spec, receiver_host, offset):
        """(address, port) a sender dials to reach ``receiver_host``'s
        endpoint at ``offset`` — honoring a per-host ``connect``
        override."""
        ov = self.connect.get(receiver_host)
        if ov:
            return str(ov[0]), int(ov[1])
        return spec.hosts[receiver_host].address, self.port + offset

    def as_dict(self):
        d = {'kind': self.kind,
             'src': self.src[0] if self.kind == 'fanout'
             and len(self.src) == 1 else list(self.src),
             'dst': self.dst[0] if self.kind in ('pipe', 'fanin')
             else list(self.dst),
             'port': self.port}
        for key in ('window', 'streams', 'crc', 'overload_policy',
                    'gulp_nbyte', 'buffer_spans'):
            v = getattr(self, key)
            if v is not None:
                d[key] = v
        if self.quota_mbps:
            d['quota_mbps'] = self.quota_mbps
        if self.quota_gulps:
            d['quota_gulps'] = self.quota_gulps
        if self.connect:
            d['connect'] = {k: list(v) for k, v in self.connect.items()}
        return d


class FabricSpec(object):
    """The whole declarative topology: named hosts + named links.
    JSON round-trippable."""

    def __init__(self, name, hosts=None, links=None):
        self.name = str(name)
        self.hosts = {}
        self.links = {}
        for hname, h in (hosts or {}).items():
            self.hosts[str(hname)] = h if isinstance(h, HostSpec) \
                else HostSpec(hname, **dict(h))
        for lname, l in (links or {}).items():
            self.links[str(lname)] = l if isinstance(l, LinkSpec) \
                else LinkSpec(lname, **dict(l))

    @classmethod
    def from_dict(cls, d):
        return cls(d.get('name', 'fabric'), d.get('hosts') or {},
                   d.get('links') or {})

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        return {'name': self.name,
                'hosts': {n: h.as_dict()
                          for n, h in sorted(self.hosts.items())},
                'links': {n: l.as_dict()
                          for n, l in sorted(self.links.items())}}

    def save(self, path):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    def validate(self):
        """Static fabric-spec check — the BF-E200/E201/W202/W203
        diagnostics (``analysis.verify.verify_fabric``)."""
        from .analysis.verify import verify_fabric
        return verify_fabric(self)

    # -- per-host views ----------------------------------------------------
    def inbound_links(self, host):
        """Links whose data ARRIVES at ``host``: [(link, offset)] —
        offset is the listener's port offset (fan-in: one entry per
        origin; fan-out: this host's leg index)."""
        out = []
        for link in self.links.values():
            for rhost, off in link.receivers():
                if rhost == host:
                    out.append((link, off))
        return out

    def outbound_links(self, host):
        """Links whose data LEAVES ``host``: [link]."""
        return [l for l in self.links.values() if host in l.src]

    def peers_of(self, host):
        """Hosts this one shares a link with (the membership set)."""
        peers = set()
        for link in self.links.values():
            members = set(link.src) | set(link.dst)
            if host in members:
                peers |= members
        peers.discard(host)
        return sorted(p for p in peers if p in self.hosts)


# ---------------------------------------------------------------------------
# membership: heartbeats over the control link
# ---------------------------------------------------------------------------

class Membership(object):
    """UDP heartbeat/membership over the spec's control ports: every
    host datagrams ``{host, role, state, ts}`` to each of its link
    peers every ``BF_FABRIC_HEARTBEAT_SECS``; a peer silent for
    ``BF_FABRIC_DEADLINE_SECS`` is marked DEAD (counted on
    ``fabric.peers.dead``), and a dead peer heard from again is a
    REJOIN (``fabric.peers.rejoined``).  The fan-out/fan-in blocks
    consult :meth:`is_dead` for their re-striping / gap-marking
    choreography; ``fabric/membership`` ProcLog publishes the live
    table.

    Beats carry a per-process ``session`` token: a peer heard under a
    NEW session (it restarted — new pid) is held as a fresh unknown
    peer for one heartbeat interval before being adopted, so a
    half-initialised restart cannot flap the death choreography.
    :meth:`confirm_resume` short-circuits the hold-down the moment a
    resume probe from the new session matches (the bridge receivers
    wire this through ``on_session_adopted``).  Session-change
    adoptions count on ``fabric.peers.readopted``, separately from
    the dead-to-alive ``fabric.peers.rejoined``."""

    def __init__(self, spec, host, state_cb=None):
        self.spec = spec
        self.host = host
        self.role = spec.hosts[host].role
        self.state_cb = state_cb      # () -> fabric state string
        self.peers = spec.peers_of(host)
        self.session = '%d.%x' % (os.getpid(),
                                  int(time.time() * 1e3) & 0xffffff)
        self._last_seen = {}
        self._peer_state = {}
        self._peer_session = {}
        #: peer -> (new_session, state, first_heard) while held down
        self._pending = {}
        #: peers vouched for by a resume probe before their first
        #: new-session beat arrived (probe/beat race on rejoin)
        self._preconfirmed = set()
        self._dead = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._sock = None
        self._start_time = None
        self._proclog = None
        self._death_events = 0
        self._rejoin_events = 0
        self._readopt_events = 0
        #: callbacks invoked (outside the lock) per newly-dead peer —
        #: the scheduler's death watch polls; the fleet collector's
        #: incident recorder subscribes here for a push verdict
        self._death_watchers = []

    def add_death_watch(self, cb):
        """Register ``cb(peer)`` to run when a peer newly misses its
        deadline (once per death event; a rejoin re-arms it).  Errors
        are swallowed and counted on ``fabric.watch_errors``."""
        with self._lock:
            if cb not in self._death_watchers:
                self._death_watchers.append(cb)

    def remove_death_watch(self, cb):
        with self._lock:
            if cb in self._death_watchers:
                self._death_watchers.remove(cb)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        me = self.spec.hosts[self.host]
        sock = socket_mod.socket(socket_mod.AF_INET,
                                 socket_mod.SOCK_DGRAM)
        sock.setsockopt(socket_mod.SOL_SOCKET,
                        socket_mod.SO_REUSEADDR, 1)
        sock.bind((me.bind_address, me.control_port))
        sock.settimeout(_hb_secs() / 2.0)
        self._sock = sock
        self._start_time = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name='bf-fabric-membership',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- queries -----------------------------------------------------------
    def is_dead(self, host):
        """Whether ``host`` has missed its deadline.  A peer never
        heard from is given the deadline from membership start before
        being declared dead (slow joiners are not dead-on-arrival)."""
        if self._start_time is None or host == self.host:
            return False
        with self._lock:
            seen = self._last_seen.get(host, self._start_time)
        return (time.monotonic() - seen) > _deadline_secs()

    def peers_snapshot(self):
        """{peer: {'alive', 'state', 'age_s'}} — the live table."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for p in self.peers:
                seen = self._last_seen.get(p)
                out[p] = {
                    'alive': not self.is_dead_locked(p, now),
                    'state': self._peer_state.get(p, '?'),
                    'age_s': round(now - seen, 3)
                    if seen is not None else None,
                }
        return out

    def is_dead_locked(self, host, now):
        seen = self._last_seen.get(host, self._start_time or now)
        return (now - seen) > _deadline_secs()

    def counts(self):
        with self._lock:
            dead = sorted(p for p in self.peers
                          if self.is_dead_locked(p, time.monotonic()))
        return {'total': len(self.peers),
                'alive': len(self.peers) - len(dead), 'dead': dead,
                'death_events': self._death_events,
                'rejoin_events': self._rejoin_events,
                'readopt_events': self._readopt_events}

    def confirm_resume(self, peer):
        """A resume probe from ``peer``'s NEW session matched — adopt
        it immediately instead of waiting out the one-heartbeat
        hold-down.  Called by the bridge receivers' session-adoption
        hook; safe to call for peers not currently held (the
        confirmation is remembered for the probe-before-beat race)."""
        rejoined = readopted = False
        with self._lock:
            if peer in self._pending:
                readopted, rejoined = self._adopt_locked(
                    peer, time.monotonic())
            elif peer in self.peers:
                self._preconfirmed.add(peer)
        if rejoined:
            counters.inc('fabric.peers.rejoined')
        if readopted:
            counters.inc('fabric.peers.readopted')

    def _adopt_locked(self, peer, now):
        """Promote a held-down new-session peer to alive.  Returns
        (readopted, rejoined) for the caller to count OUTSIDE the
        lock."""
        session, state, _first = self._pending.pop(peer)
        self._preconfirmed.discard(peer)
        self._peer_session[peer] = session
        self._last_seen[peer] = now
        self._peer_state[peer] = state
        was_dead = peer in self._dead
        if was_dead:
            self._dead.discard(peer)
            self._rejoin_events += 1
        self._readopt_events += 1
        return True, was_dead

    # -- loop --------------------------------------------------------------
    def _run(self):
        last_tx = 0.0
        targets = [(self.spec.hosts[p].address,
                    self.spec.hosts[p].control_port, p)
                   for p in self.peers
                   if self.spec.hosts[p].control_port]
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_tx >= _hb_secs():
                last_tx = now
                state = 'OK'
                if self.state_cb is not None:
                    try:
                        state = self.state_cb() or 'OK'
                    except Exception:
                        pass
                payload = json.dumps(
                    {'host': self.host, 'role': self.role,
                     'state': state,
                     'session': self.session}).encode()
                for addr, port, _p in targets:
                    try:
                        self._sock.sendto(payload, (addr, port))
                        counters.inc('fabric.heartbeats.tx')
                    except OSError:
                        pass
                self._check_deaths(now)
                self._publish()
            try:
                data, _src = self._sock.recvfrom(4096)
            except socket_mod.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            try:
                beat = json.loads(data.decode())
                peer = beat.get('host')
            except (ValueError, UnicodeDecodeError):
                continue
            if peer in self.peers:
                counters.inc('fabric.heartbeats.rx')
                session = beat.get('session')
                state = beat.get('state', '?')
                hb_now = time.monotonic()
                rejoined = readopted = False
                with self._lock:
                    known = self._peer_session.get(peer)
                    if session is not None and known is not None \
                            and session != known:
                        # restarted peer (new pid/session): hold it
                        # as a fresh unknown for one heartbeat
                        # interval — unless a resume probe already
                        # vouched for the new session
                        pend = self._pending.get(peer)
                        first = pend[2] if pend and pend[0] == session \
                            else hb_now
                        self._pending[peer] = (session, state, first)
                        if peer in self._preconfirmed or \
                                hb_now - first >= _hb_secs():
                            readopted, rejoined = \
                                self._adopt_locked(peer, hb_now)
                    else:
                        if session is not None:
                            self._peer_session[peer] = session
                        was_dead = peer in self._dead
                        self._last_seen[peer] = hb_now
                        self._peer_state[peer] = state
                        if was_dead:
                            self._dead.discard(peer)
                            self._rejoin_events += 1
                            rejoined = True
                if rejoined:
                    counters.inc('fabric.peers.rejoined')
                if readopted:
                    counters.inc('fabric.peers.readopted')

    def _check_deaths(self, now):
        newly = []
        with self._lock:
            for p in self.peers:
                if p in self._dead:
                    continue
                if self.is_dead_locked(p, now):
                    self._dead.add(p)
                    self._death_events += 1
                    newly.append(p)
            watchers = list(self._death_watchers)
        for p in newly:
            counters.inc('fabric.peers.dead')
            for cb in watchers:
                try:
                    cb(p)
                except Exception:
                    counters.inc('fabric.watch_errors')

    def _publish(self):
        try:
            if self._proclog is None:
                self._proclog = ProcLog('fabric/membership')
            snap = self.peers_snapshot()
            entry = {'host': self.host, 'role': self.role,
                     'peers': len(self.peers)}
            for p, info in sorted(snap.items()):
                entry['peer.%s' % p] = '%s:%s' % (
                    'alive' if info['alive'] else 'DEAD',
                    info['state'])
            self._proclog.update(entry)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# durable ack/shed ledger (rejoin resume + loss accounting)
# ---------------------------------------------------------------------------

class AckLedger(object):
    """Durable per-(fabric, host, link) journal of DELIVERED (acked)
    and SHED bytes, written under ``BF_FABRIC_STATE``.  Two jobs:

    - **rejoin frontier**: a relaunched sender host resumes its
      deterministic source from ``acked_frames(seq)`` when the live
      resume probe (``io.bridge.query_resume``) cannot answer;
    - **loss accounting across a SIGKILL**: the killed process's
      in-memory counters die with it, but this journal survives — the
      produced == delivered + shed audit reads it.
    """

    #: minimum seconds between journal writes (every ack would be an
    #: fsync storm; the frontier only needs to be approximately fresh
    #: — the live resume probe is the exact source of truth)
    SAVE_INTERVAL = 0.05

    def __init__(self, fabric, host, link):
        self.path = os.path.join(
            fabric_state_dir(), str(fabric),
            '%s.%s.json' % (host, link))
        self._lock = threading.Lock()
        self._last_save = 0.0
        self.acked = {}
        self.acked_bytes = 0
        self.shed_gulps = 0
        self.shed_bytes = 0
        try:
            with open(self.path) as f:
                d = json.load(f)
            self.acked = {str(k): int(v)
                          for k, v in (d.get('acked') or {}).items()}
            self.acked_bytes = int(d.get('acked_bytes', 0))
            self.shed_gulps = int(d.get('shed_gulps', 0))
            self.shed_bytes = int(d.get('shed_bytes', 0))
        except (OSError, ValueError):
            pass

    @property
    def has_history(self):
        return bool(self.acked or self.shed_bytes)

    def acked_frames(self, seq_name):
        with self._lock:
            return self.acked.get(str(seq_name), 0)

    def note_acked(self, seq_name, frame_offset, nframe, nbyte):
        """RingSender ``on_span_acked`` hook: advance the delivered
        frontier (frames are acked in order, but a retransmit may
        re-ack — the frontier is a max, never a sum)."""
        with self._lock:
            key = str(seq_name)
            frontier = frame_offset + nframe
            if frontier > self.acked.get(key, 0):
                self.acked_bytes += nbyte
                self.acked[key] = frontier
        self.save()

    def note_shed(self, ngulps, nbyte):
        with self._lock:
            self.shed_gulps += int(ngulps)
            self.shed_bytes += int(nbyte)
        self.save()

    def save(self, force=False):
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_save < self.SAVE_INTERVAL:
                return
            self._last_save = now
            payload = json.dumps(
                {'acked': dict(self.acked),
                 'acked_bytes': self.acked_bytes,
                 'shed_gulps': self.shed_gulps,
                 'shed_bytes': self.shed_bytes}, sort_keys=True)
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + '.tmp'
            with open(tmp, 'w') as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# fan-out: one ring -> N downstream hosts, striped by sequence
# ---------------------------------------------------------------------------

class FanOutBlock(Block):
    """Sequence-striped fan-out: sequence ``i`` of
    the input ring is forwarded whole into leg ring ``i mod N``, each
    leg ring pumped to its downstream host by its own BridgeSink.

    Failure choreography: leg liveness comes from fabric membership —
    a sequence about to stripe onto a DEAD leg is re-striped across
    the survivors instead (counted on ``fabric.fanout.restripes``).
    The leg rings run ``drop_oldest`` and the leg sinks are
    restart-policy, so a leg that dies MID-sequence sheds (byte-exact
    shed ledger: ``ring.<leg>.shed_*``) rather than stalling the fan,
    and a rejoining leg resumes from its ring + the v2 retransmit
    window."""

    def __init__(self, iring, legs, membership=None, link=None,
                 window=None, streams=None, crc=None,
                 quota_bytes_per_s=None, quota_gulps_per_s=None,
                 on_span_acked=None, on_shed=None,
                 overload_policy='drop_oldest', buffer_spans=None,
                 *args, **kwargs):
        kwargs.setdefault('overload_policy', overload_policy)
        super(FanOutBlock, self).__init__([iring], *args, **kwargs)
        from .blocks.bridge import BridgeSink
        from .io.bridge import bridge_window
        self.link = link or self.name
        self.membership = membership
        self.window = bridge_window() if window is None \
            else max(int(window), 1)
        #: leg-ring depth in spans: the absorption budget between a
        #: leg stalling and its drop policy engaging (default
        #: max(window+2, 8) — the BF-W110 floor plus slack so a
        #: healthy burst rides backpressure instead of shedding)
        self.buffer_spans = max(int(buffer_spans), self.window + 2) \
            if buffer_spans is not None else max(self.window + 2, 8)
        #: legs: [(leg_host_name, address, port)]
        self.legs = [(str(n), str(a), int(p)) for n, a, p in legs]
        if not self.legs:
            raise FabricSpecError('fan-out %r has no legs' % self.link)
        self.orings = [self.create_ring(space='system')
                       for _leg in self.legs]
        self.sinks = []
        for i, (lname, addr, port) in enumerate(self.legs):
            self.sinks.append(BridgeSink(
                self.orings[i], addr, port, window=self.window,
                nstreams=streams, crc=crc,
                quota_bytes_per_s=quota_bytes_per_s,
                quota_gulps_per_s=quota_gulps_per_s,
                name='%s_leg_%s' % (self.name, lname),
                # leg sequences appear lazily per stripe, AFTER the
                # init barrier — an early prime would deadlock it
                prime_early=False,
                # the sink's credit window stays on 'block': the leg
                # RING's drop policy is the single counted shedding
                # site (two sites would double-count a span the
                # sender skipped and the ring then overwrote).  A
                # stalled-but-alive leg backpressures into the ring
                # (which sheds in the sender's no-open-span windows);
                # a DEAD leg's sender aborts and RELEASES its pinned
                # spans, so the ring sheds freely and the fan never
                # wedges.
                overload_policy='block',
                on_failure='restart'))
            if on_span_acked is not None:
                self.sinks[-1].on_span_acked = on_span_acked
            if on_shed is not None:
                self.sinks[-1].on_fabric_shed = on_shed
        self.out_proclog = ProcLog(self.name + '/out')
        rnames = {'nring': len(self.orings)}
        for i, r in enumerate(self.orings):
            rnames['ring%i' % i] = r.name
        self.out_proclog.update(rnames)
        self._stripe = 0

    def _define_valid_input_spaces(self):
        return ['system']

    def define_output_nframes(self, input_nframes):
        return [input_nframes[0]] * len(self.orings)

    def _leg_dead(self, idx):
        if self.membership is None:
            return False
        try:
            return self.membership.is_dead(self.legs[idx][0])
        except Exception:
            return False

    def _pick_leg(self, stripe):
        """Leg index for output sequence ``stripe``: the modulo home
        leg, unless membership says it is dead — then a counted
        re-stripe across the survivors (all-dead falls back to the
        home leg: its ring sheds rather than the fan stalling)."""
        n = len(self.legs)
        home = stripe % n
        if not self._leg_dead(home):
            return home
        survivors = [i for i in range(n) if not self._leg_dead(i)]
        if not survivors:
            # no survivor to re-stripe to: the home leg's ring sheds
            # (counted there) rather than the fan stalling
            return home
        counters.inc('fabric.fanout.restripes')
        return survivors[stripe % len(survivors)]

    def main(self, active_orings):
        # bridge-style init: our sequences come from the input ring,
        # and the leg sinks are already checked in — park nobody
        self.pipeline.block_init_queue.put((self, True))
        self.heartbeat()
        for seq in self.irings[0].read(guarantee=True):
            if self.shutdown_event.is_set():
                break
            leg = self._pick_leg(self._stripe)
            hdr = dict(seq.header)
            tag = dict(hdr.get(FABRIC_HEADER_KEY) or {})
            tag.update({'link': self.link, 'stripe': self._stripe,
                        'leg': self.legs[leg][0]})
            hdr[FABRIC_HEADER_KEY] = tag
            gulp = max(int(hdr.get('gulp_nframe', 1) or 1), 1)
            counters.inc('fabric.fanout.sequences')
            self._stripe += 1
            oseq = active_orings[leg].begin_sequence(
                hdr, gulp, buf_nframe=self.buffer_spans * gulp)
            try:
                for span in seq.read(gulp):
                    if span.nframe == 0:
                        continue
                    data = span.data.as_numpy()
                    ospan = oseq.reserve(span.nframe)
                    try:
                        ospan.data.as_numpy()[:span.nframe] = data
                        ospan.commit(span.nframe)
                    except BaseException:
                        ospan.commit(0)
                        ospan.close()
                        raise
                    ospan.close()
                    self.heartbeat()
                    if self.shutdown_event.is_set():
                        break
            finally:
                oseq.end()


# ---------------------------------------------------------------------------
# fan-in: N capture origins -> one ring, gap-marked, never stalled
# ---------------------------------------------------------------------------

class FanInBlock(Block):
    """N-origin fan-in: merges the origin rings into
    ONE output ring at sequence granularity, round-robin fair, each
    output sequence tagged with its origin (``_fabric``: origin host,
    origin sequence ordinal, link).

    The merge NEVER stalls on a dead origin: while streaming an
    origin's sequence, silence past ``BF_FABRIC_GAP_SECS`` — or an
    immediate membership death verdict — closes the output sequence
    early, counts ``fabric.fanin.gapped``, and moves on; the gap is
    stamped into the next output headers via ``_overload``
    (``fabric_gapped``) so downstream consumers know the stream is
    gapped WITHOUT a telemetry side channel.  When the origin rejoins
    (session adoption + resume probe upstream), its remaining frames
    continue as a tagged continuation sequence (``resumed: True``)."""

    #: bounded per-origin staging queue (gulps); the real buffering is
    #: the origin ring — this only decouples the reader threads from
    #: the single writer
    QUEUE_GULPS = 8

    def __init__(self, origin_rings, origins=None, membership=None,
                 link=None, gap_secs=None, *args, **kwargs):
        super(FanInBlock, self).__init__(list(origin_rings), *args,
                                         **kwargs)
        self.link = link or self.name
        self.membership = membership
        self.gap_secs = gap_secs
        self.origins = [str(o) for o in (origins or [])]
        while len(self.origins) < len(self.irings):
            self.origins.append('origin%d' % len(self.origins))
        self.orings = [self.create_ring(space='system')]
        self.out_proclog = ProcLog(self.name + '/out')
        self.out_proclog.update({'nring': 1,
                                 'ring0': self.orings[0].name})
        #: origins -> sequences emitted / gap events (the _overload
        #: stamp's payload)
        self._origin_seq = {}
        self._gaps = {}

    def _define_valid_input_spaces(self):
        return ['system'] * len(self.irings)

    def define_output_nframes(self, input_nframes):
        return [input_nframes[0] if input_nframes else 1]

    # -- reader threads ----------------------------------------------------
    def _q_put(self, q, item):
        while True:
            try:
                q.put(item, timeout=0.25)
                return True
            except Full:
                if self.shutdown_event.is_set() or self._writer_done:
                    return False

    def _origin_reader(self, idx, q):
        try:
            for seq in self.irings[idx].read(guarantee=True):
                hdr = dict(seq.header)
                if not self._q_put(q, ('header', hdr)):
                    return
                gulp = max(int(hdr.get('gulp_nframe', 1) or 1), 1)
                for span in seq.read(gulp):
                    if span.nframe == 0:
                        continue
                    data = np.array(span.data.as_numpy(), copy=True)
                    if not self._q_put(q, ('data', data)):
                        return
                if not self._q_put(q, ('end', None)):
                    return
        except RingPoisonedError:
            pass
        except Exception:
            counters.inc('fabric.fanin.origin_failures')
        finally:
            while not self._q_put(q, ('eos', None)):
                if self.shutdown_event.is_set() or self._writer_done:
                    break

    # -- writer ------------------------------------------------------------
    def _mark_gap(self, idx, reason):
        origin = self.origins[idx]
        counters.inc('fabric.fanin.gapped')
        entry = self._gaps.setdefault(origin, {'gaps': 0,
                                               'reason': reason})
        entry['gaps'] += 1
        entry['reason'] = reason

    def _tag_header(self, idx, hdr, resumed=False):
        origin = self.origins[idx]
        ordinal = self._origin_seq.get(origin, 0)
        self._origin_seq[origin] = ordinal + 1
        out = dict(hdr)
        tag = dict(out.get(FABRIC_HEADER_KEY) or {})
        tag.update({'origin': origin, 'origin_seq': ordinal,
                    'link': self.link})
        if resumed:
            tag['resumed'] = True
        out[FABRIC_HEADER_KEY] = tag
        if self._gaps:
            # the _overload stamp: consumers —
            # including remote ones, the bridge ships headers verbatim
            # — learn the merged stream is GAPPED and by which origins
            ov = dict(out.get('_overload') or {})
            ov['fabric_gapped'] = {
                o: dict(g) for o, g in sorted(self._gaps.items())}
            out['_overload'] = ov
        if resumed:
            out['name'] = '%s.r%d' % (out.get('name', origin), ordinal)
        return out

    def main(self, active_orings):
        self._writer_done = False
        self.pipeline.block_init_queue.put((self, True))
        self.heartbeat()
        n = len(self.irings)
        queues = [Queue(self.QUEUE_GULPS) for _ in range(n)]
        threads = [threading.Thread(
            target=self._origin_reader, args=(i, queues[i]),
            name='%s-rx%d' % (self.name, i), daemon=True)
            for i in range(n)]
        for t in threads:
            t.start()
        try:
            self._merge(active_orings[0], queues)
        finally:
            self._writer_done = True
            for t in threads:
                t.join(timeout=2.0)

    def _merge(self, writer, queues):
        gap_secs = self.gap_secs if self.gap_secs is not None \
            else _gap_secs()
        n = len(queues)
        open_origins = set(range(n))
        #: per-origin pending continuation header (gap mid-sequence)
        cur_hdr = [None] * n
        rr = 0
        active = None
        oseq = None
        gulp = 1
        last_item = time.monotonic()

        def close_seq():
            nonlocal oseq, active
            if oseq is not None:
                oseq.end()
            oseq = None
            active = None

        def open_seq(idx, hdr, resumed=False):
            nonlocal oseq, active, gulp, last_item
            tagged = self._tag_header(idx, hdr, resumed=resumed)
            gulp = max(int(tagged.get('gulp_nframe', 1) or 1), 1)
            oseq = writer.begin_sequence(tagged, gulp,
                                         buf_nframe=4 * gulp)
            active = idx
            last_item = time.monotonic()
            counters.inc('fabric.fanin.sequences')

        try:
            while (open_origins or active is not None) \
                    and not self.shutdown_event.is_set():
                if active is None:
                    # pick the next origin with something pending,
                    # round-robin fair; dead origins' leftovers still
                    # drain (their data is already here)
                    progressed = False
                    for k in range(n):
                        idx = (rr + k) % n
                        if idx not in open_origins \
                                and queues[idx].empty():
                            continue
                        try:
                            kind, payload = queues[idx].get_nowait()
                        except Empty:
                            continue
                        rr = idx + 1
                        progressed = True
                        if kind == 'header':
                            cur_hdr[idx] = dict(payload)
                            open_seq(idx, payload)
                        elif kind == 'data':
                            # continuation: data resuming after a gap
                            hdr = cur_hdr[idx] or {}
                            open_seq(idx, hdr, resumed=True)
                            self._write_gulp(oseq, payload)
                        elif kind == 'end':
                            cur_hdr[idx] = None
                        elif kind == 'eos':
                            open_origins.discard(idx)
                        break
                    if not progressed:
                        if not open_origins:
                            break
                        time.sleep(0.01)
                    continue
                # streaming the active origin's sequence
                try:
                    kind, payload = queues[active].get(timeout=0.05)
                except Empty:
                    idle = time.monotonic() - last_item
                    dead = self.membership is not None and \
                        self.membership.is_dead(self.origins[active])
                    if dead or idle > gap_secs:
                        # dead (or silently wedged) origin: mark the
                        # stream gapped and MOVE ON — never stall the
                        # merge on one origin
                        self._mark_gap(active,
                                       'dead' if dead
                                       else 'idle %.2fs' % idle)
                        close_seq()
                    continue
                last_item = time.monotonic()
                if kind == 'data':
                    self._write_gulp(oseq, payload)
                    self.heartbeat()
                elif kind == 'end':
                    cur_hdr[active] = None
                    close_seq()
                elif kind == 'eos':
                    open_origins.discard(active)
                    close_seq()
                elif kind == 'header':
                    # a new sequence without an 'end' (adoption after
                    # a whole-host rejoin truncated the old one)
                    idx = active
                    close_seq()
                    cur_hdr[idx] = dict(payload)
                    open_seq(idx, payload)
        finally:
            close_seq()

    def _write_gulp(self, oseq, data):
        nframe = int(data.shape[0])
        ospan = oseq.reserve(nframe)
        try:
            ospan.data.as_numpy()[:nframe] = data
            ospan.commit(nframe)
        except BaseException:
            ospan.commit(0)
            ospan.close()
            raise
        ospan.close()


# ---------------------------------------------------------------------------
# per-host affinity (the dormant affinity.py, woken)
# ---------------------------------------------------------------------------

def apply_affinity(hostspec, pipeline=None):
    """Apply a host spec's core pins: the launcher process is bound to
    the core set (``sched_setaffinity``), and the pipeline's blocks
    are distributed round-robin over the cores (each block thread then
    pins itself via the existing ``core`` tunable in ``Block.run``).
    Returns ``'applied'``, ``'skipped'`` (unsupported platform —
    counted, not fatal), or ``'none'`` (no pins requested)."""
    cores = getattr(hostspec, 'cores', None)
    if not cores:
        return 'none'
    try:
        os.sched_setaffinity(0, set(int(c) for c in cores))
    except (AttributeError, OSError, ValueError):
        counters.inc('fabric.affinity.skipped')
        return 'skipped'
    if pipeline is not None:
        for i, block in enumerate(pipeline.blocks):
            # only blocks without their own pin: an explicit per-block
            # core in the builder wins over the spec's round-robin
            if block.__dict__.get('_core') is None:
                block._core = int(cores[i % len(cores)])
    counters.inc('fabric.affinity.applied')
    return 'applied'


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

class FabricHostContext(object):
    """What a per-host builder receives: the spec, this host's name,
    and the link endpoints already materialized for it.

    - ``source(link)`` -> the block producing that link's arriving
      stream on this host (BridgeSource, or the FanInBlock for a
      fan-in link) — compose your processing chain from it;
    - ``sink(link, upstream)`` -> attach this host's sending endpoint
      (BridgeSink, or a FanOutBlock for a fan-out link) fed by
      ``upstream`` (a block or ring);
    - ``resume_offset(link, seq_name)`` -> frames of ``seq_name`` the
      downstream endpoint already committed (live probe, falling back
      to the durable ledger): a deterministic capture source starts
      HERE after a rejoin, replaying only unacked frames.
    """

    def __init__(self, fabric_host):
        self._fh = fabric_host
        self.spec = fabric_host.spec
        self.host = fabric_host.host
        self.membership = fabric_host.membership

    def source(self, link_name):
        try:
            return self._fh._sources[link_name]
        except KeyError:
            raise FabricSpecError(
                'host %r has no inbound link %r (inbound: %s)'
                % (self.host, link_name,
                   sorted(self._fh._sources) or 'none'))

    def sink(self, link_name, upstream):
        return self._fh._make_sink(link_name, upstream)

    def resume_offset(self, link_name, seq_name):
        return self._fh.resume_offset(link_name, seq_name)

    def resume_map(self, link_name):
        return self._fh.resume_map(link_name)


class FabricHost(object):
    """Materialize and run ONE host's sub-pipeline of a fabric spec.

    ``builder(ctx)`` wires the host's processing between the
    spec-declared link endpoints via :class:`FabricHostContext`.
    :meth:`build` constructs the Pipeline (without running);
    :meth:`run` applies the spec's core pins, starts membership,
    installs the SIGTERM drain, publishes ``fabric/health``, and runs
    the pipeline to completion."""

    def __init__(self, spec, host, builder=None, pipeline_kwargs=None,
                 jitter=True):
        if isinstance(spec, dict):
            spec = FabricSpec.from_dict(spec)
        if host not in spec.hosts:
            raise FabricSpecError(
                'host %r is not in fabric %r (hosts: %s)'
                % (host, spec.name, sorted(spec.hosts)))
        self.spec = spec
        self.host = host
        self.builder = builder
        self.pipeline_kwargs = dict(pipeline_kwargs or {})
        #: apply the jittered-rejoin delay on build (disable for
        #: build-only verification topologies)
        self.jitter = bool(jitter)
        self.pipeline = None
        self.membership = None
        self._sources = {}
        self._sunk = set()
        self._ledgers = {}
        self._resume_cache = {}
        self._proclog = None
        self._state = 'OK'
        self._health_stop = threading.Event()
        self._health_thread = None
        self.rejoining = False

    # -- ledger / resume ---------------------------------------------------
    def ledger(self, link_name):
        if link_name not in self._ledgers:
            self._ledgers[link_name] = AckLedger(
                self.spec.name, self.host, link_name)
        return self._ledgers[link_name]

    def resume_map(self, link_name):
        """The rejoin frontier for every sequence of ``link_name``:
        ``{seq_name: committed_frames}`` — the LIVE probe answer when
        the downstream endpoint is reachable (exact), max-merged with
        the durable ledger (conservative fallback when it is not).  A
        relaunched deterministic source resumes each sequence from its
        frontier, replaying only frames the receiver never
        committed.  Cached per link: one probe (and one counter
        update) per launch, however many sequences consult it."""
        from .io.bridge import query_resume
        if link_name in self._resume_cache:
            return dict(self._resume_cache[link_name])
        link = self.spec.links.get(link_name)
        if link is None or self.host not in link.src:
            raise FabricSpecError(
                'host %r does not send on link %r'
                % (self.host, link_name))
        merged = dict(self.ledger(link_name).acked)
        try:
            rhost, roff = self._my_endpoint(link)
            addr, port = link.dial_target(self.spec, rhost, roff)
            for name, frames in query_resume(addr, port,
                                             timeout=3.0).items():
                merged[name] = max(merged.get(name, 0), int(frames))
        except Exception:
            counters.inc('fabric.resume.probe_failures')
        skipped = sum(merged.values())
        if skipped > 0:
            self.rejoining = True
            # frames the downstream already has = frames NOT replayed
            counters.inc('fabric.resume.skipped_frames', skipped)
        self._resume_cache[link_name] = dict(merged)
        return merged

    def resume_offset(self, link_name, seq_name):
        """Frames of ``seq_name`` the downstream endpoint of
        ``link_name`` has committed (see :meth:`resume_map`)."""
        return self.resume_map(link_name).get(str(seq_name), 0)

    def _my_endpoint(self, link):
        """(receiver_host, port_offset) this host's sender dials for
        ``link`` (fan-in origins use their origin index; fan-out has
        per-leg endpoints and is handled by FanOutBlock)."""
        if link.kind == 'fanin':
            return link.dst[0], link.src.index(self.host)
        return link.dst[0], 0

    # -- construction ------------------------------------------------------
    def build(self):
        """Construct (but do not run) this host's Pipeline."""
        me = self.spec.hosts[self.host]
        # identity = REAL machine hostname + '<spec-host>-<role>': the
        # machine hostname keeps proclog's stale-tree GC working (it
        # only probes PIDs of entries stamped with the LOCAL host), and
        # the fabric host/role ride in the role part
        set_identity(socket_mod.gethostname(),
                     '%s-%s' % (self.host, me.role))
        self.membership = Membership(self.spec, self.host,
                                     state_cb=lambda: self._state)
        # jittered rejoin: a relaunched host with
        # durable ledger history waits a random slice of
        # BF_FABRIC_REJOIN_CAP before dialing anyone, so a fleet
        # restarting after an outage does not arrive in one wave
        if self.jitter and any(
                self.ledger(l.name).has_history
                for l in self.spec.outbound_links(self.host)):
            self.rejoining = True
            cap = _rejoin_cap()
            if cap > 0:
                counters.inc('fabric.rejoins')
                time.sleep(random.uniform(0, cap))
        from .blocks.bridge import BridgeSource
        pipeline = Pipeline(
            name='fabric_%s_%s' % (self.spec.name, self.host),
            **self.pipeline_kwargs)
        with pipeline:
            # inbound endpoints first: listeners must exist before any
            # peer's sender dials
            fanin_parts = {}
            for link, off in self.spec.inbound_links(self.host):
                src = BridgeSource(
                    me.bind_address, link.port + off,
                    adopt_sessions=True, crc=link.crc,
                    name='rx_%s_%d' % (link.name, off))
                # a resume probe / session adoption on this endpoint
                # vouches for the (possibly restarted) origin host:
                # end its membership hold-down immediately instead of
                # waiting out a heartbeat interval
                origin = link.src[off] if link.kind == 'fanin' \
                    else link.src[0]
                src.on_session_adopted = (
                    lambda peer=origin:
                    self.membership.confirm_resume(peer))
                if link.kind == 'fanin':
                    fanin_parts.setdefault(link.name, []).append(
                        (off, src))
                else:
                    self._sources[link.name] = src
            for lname, parts in fanin_parts.items():
                link = self.spec.links[lname]
                parts.sort()
                self._sources[lname] = FanInBlock(
                    [p[1] for p in parts], origins=list(link.src),
                    membership=self.membership, link=lname,
                    name='fanin_%s' % lname)
            if self.builder is not None:
                self.builder(FabricHostContext(self))
            missing = [l.name
                       for l in self.spec.outbound_links(self.host)
                       if l.name not in self._sunk]
            if missing:
                raise FabricSpecError(
                    'host %r sends on link(s) %s but the builder '
                    'never attached them (ctx.sink(<link>, '
                    '<upstream>))' % (self.host, sorted(missing)))
        self.pipeline = pipeline
        return pipeline

    def _make_sink(self, link_name, upstream):
        from .blocks.bridge import BridgeSink
        link = self.spec.links.get(link_name)
        if link is None or self.host not in link.src:
            raise FabricSpecError(
                'host %r does not send on link %r (outbound: %s)'
                % (self.host, link_name,
                   [l.name for l in
                    self.spec.outbound_links(self.host)]))
        ledger = self.ledger(link_name)

        def on_shed(reason, ngulps, nbyte):
            ledger.note_shed(ngulps, nbyte)

        if link.kind == 'fanout':
            legs = []
            for j, leg in enumerate(link.dst):
                addr, port = link.dial_target(self.spec, leg, j)
                legs.append((leg, addr, port))
            block = FanOutBlock(
                upstream, legs, membership=self.membership,
                link=link_name, window=link.window,
                streams=link.streams, crc=link.crc,
                quota_bytes_per_s=link.quota_mbps * 1e6
                if link.quota_mbps else None,
                quota_gulps_per_s=link.quota_gulps or None,
                on_span_acked=ledger.note_acked, on_shed=on_shed,
                overload_policy=link.overload_policy or 'drop_oldest',
                buffer_spans=link.buffer_spans,
                name='fanout_%s' % link_name)
        else:
            rhost, roff = self._my_endpoint(link)
            addr, port = link.dial_target(self.spec, rhost, roff)
            block = BridgeSink(
                upstream, addr, port, window=link.window,
                nstreams=link.streams, crc=link.crc,
                quota_bytes_per_s=link.quota_mbps * 1e6
                if link.quota_mbps else None,
                quota_gulps_per_s=link.quota_gulps or None,
                name='tx_%s' % link_name, on_failure='restart')
            block.on_span_acked = ledger.note_acked
            block.on_fabric_shed = on_shed
        self._sunk.add(link_name)
        return block

    # -- fabric health rollup ----------------------------------------------
    def _evaluate(self):
        """Fabric state = the local pipeline health escalated by
        membership: any dead link peer holds the state at DEGRADED or
        worse (the data plane is running on survivors)."""
        state = 'OK'
        if self.pipeline is not None:
            try:
                state = self.pipeline.health().get('state', 'OK')
            except Exception:
                state = 'OK'
        mcounts = self.membership.counts() if self.membership else \
            {'total': 0, 'alive': 0, 'dead': []}
        if mcounts['dead'] and _SEV[state] < _SEV['DEGRADED']:
            state = 'DEGRADED'
        prev = self._state
        self._state = state
        if state != prev:
            counters.inc('fabric.health.transitions')
        return state, mcounts

    def _publish_health(self):
        try:
            state, mcounts = self._evaluate()
            if self._proclog is None:
                self._proclog = ProcLog('fabric/health')
            h = histograms.get('slo.fabric_exit_age_s')
            entry = {
                'state': state, 'host': self.host,
                'role': self.spec.hosts[self.host].role,
                'fabric': self.spec.name,
                'peers_total': mcounts['total'],
                'peers_alive': mcounts['alive'],
                'peers_dead': ','.join(mcounts['dead']) or 'none',
                'gapped': counters.get('fabric.fanin.gapped'),
                'restripes': counters.get('fabric.fanout.restripes'),
            }
            if h is not None and h.count:
                entry['fabric_exit_age_p99_ms'] = round(
                    h.percentile(99) * 1e3, 3)
            self._proclog.update(entry, force=True)
        except Exception:
            pass

    def _health_loop(self):
        while not self._health_stop.wait(0.5):
            self._publish_health()

    def health(self):
        """Current fabric-level health: the rolled-up state, the
        membership table, and the local pipeline's health dict."""
        state, mcounts = self._evaluate()
        return {'state': state, 'host': self.host,
                'peers': (self.membership.peers_snapshot()
                          if self.membership else {}),
                'membership': mcounts,
                'pipeline': (self.pipeline.health()
                             if self.pipeline is not None else None)}

    # -- run ---------------------------------------------------------------
    def run(self, install_signals=True):
        """Build (if needed), pin, start membership, and run this
        host's pipeline to completion.  SIGTERM/SIGINT drain the WHOLE
        fabric cleanly: the pipeline shutdown rides the existing
        choreography — senders emit MSG_END between spans and drain
        their credit windows, so downstream hosts see a clean end of
        stream, finish, and exit in topology order."""
        if self.pipeline is None:
            self.build()
        affinity_state = apply_affinity(self.spec.hosts[self.host],
                                        self.pipeline)
        self.membership.start()
        if install_signals:
            try:
                self.pipeline.shutdown_on_signals()
            except ValueError:
                pass                 # not the main thread (tests)
        self._health_thread = threading.Thread(
            target=self._health_loop, name='bf-fabric-health',
            daemon=True)
        self._health_thread.start()
        try:
            ProcLog('fabric/launch').update(
                {'host': self.host, 'fabric': self.spec.name,
                 'affinity': affinity_state,
                 'rejoining': int(self.rejoining)}, force=True)
            self.pipeline.run()
        finally:
            self._health_stop.set()
            if self._health_thread is not None:
                self._health_thread.join(timeout=2.0)
            self._publish_health()
            for ledger in self._ledgers.values():
                ledger.save(force=True)
            if self.membership is not None:
                self.membership.stop()


def launch(spec, host, builder, pipeline_kwargs=None, run=True):
    """Convenience: materialize and (by default) run ``host``'s
    sub-pipeline of ``spec`` with ``builder``; returns the
    :class:`FabricHost`."""
    fh = FabricHost(spec, host, builder,
                    pipeline_kwargs=pipeline_kwargs)
    fh.build()
    if run:
        fh.run()
    return fh
