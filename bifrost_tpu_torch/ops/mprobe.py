"""Measured implementation selection (the port of
``bifrost_tpu/ops/mprobe.py``).

The policy is the JAX package's:

- candidates are measured at the actual shape, never asserted;
- timing is best-of-N, so first-call jitter cannot freeze a slower
  winner into the cache;
- winners are cached in-process and on disk, keyed by the card, the
  package version and a caller-supplied shape signature;
- the disk entry is written only when every candidate ran clean AND the
  winner's margin over the runner-up exceeds a noise threshold; a
  transient failure or a coin-flip ranking is measured again next
  session;
- a coin-flip winner (margin inside the noise threshold) is raced again
  within a session after ``BF_MPROBE_REPROBE`` uses (default 200; 0
  disables).

Timing brackets each repetition with ``torch.cuda.synchronize()`` on the
card (where ``jax.block_until_ready`` drained the JAX package's calls).
The default cache directory is the port's own, ``~/.bifrost_tpu_torch``
(``BF_CACHE_DIR`` overrides it, as in the JAX package), and every key
starts with the backend tag ``torch-cuda:<card>`` or ``torch-cpu:cpu``,
so a winner measured by the JAX package is never served to the port,
nor the other way round.  Families (one cache file each): ``beamform``,
``xengine``, ``linalg_xcorr``, ``fdmt`` and ``corner_turn`` (the
correlator's mesh plans, keyed as the JAX block keys them:
``v=<gulp shape> <dtype> ndev=<ranks> acc=<class>``).
"""

from __future__ import annotations

import json
import os
import time

__all__ = ['select', 'peek', 'backend_tag', 'cache_path']

_cache = {}
#: (name, full_key) -> uses served from cache for a coin-flip winner;
#: when a counter reaches the BF_MPROBE_REPROBE budget the entry is
#: evicted and measured again
_flip_uses = {}


def _reprobe_budget():
    """Cache-uses budget for coin-flip winners (``BF_MPROBE_REPROBE``,
    default 200; 0 disables the re-race)."""
    try:
        return int(os.environ.get('BF_MPROBE_REPROBE', '') or 200)
    except ValueError:
        return 200


def _coin_flip(ms, noise):
    """Whether a measurement's ranking is inside the noise threshold."""
    try:
        ranked = sorted(float(v) for v in ms.values())
    except (TypeError, ValueError):
        return False
    return (len(ranked) >= 2 and ranked[0] > 0 and
            ranked[1] < ranked[0] * noise)


def _flip_spent(name, full_key, ms, noise):
    """Count one cache use of a coin-flip winner; True when the reprobe
    budget is spent (the caller evicts and measures again)."""
    budget = _reprobe_budget()
    if budget <= 0 or not _coin_flip(ms, noise):
        return False
    key = (name, full_key)
    uses = _flip_uses.get(key, 0) + 1
    if uses >= budget:
        _flip_uses.pop(key, None)
        return True
    _flip_uses[key] = uses
    return False


def _read_disk(name):
    try:
        with open(cache_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def peek(name, key):
    """Cached (winner, ms, errors) for ``key`` or None: consults the
    in-process and disk caches without measuring anything."""
    full_key = '%s|%s' % (backend_tag(), key)
    fam = _cache.get(name, {})
    if full_key in fam:
        return fam[full_key]
    disk = _read_disk(name)
    if full_key in disk:
        entry = (disk[full_key].get('winner'),
                 disk[full_key].get('ms', {}), {})
        _cache.setdefault(name, {})[full_key] = entry
        return entry
    return None


def cache_path(name):
    base = os.environ.get('BF_CACHE_DIR')
    if base is None:
        base = os.path.join(os.path.expanduser('~'), '.bifrost_tpu_torch')
    return os.path.join(base, '%s.json' % name)


def backend_tag():
    """``torch-<device type>:<device name>:v<version>``, the prefix of
    every probe key: a winner measured on one card or package version is
    not reused where the ranking can differ.  The device name is
    ``torch.cuda.get_device_name()`` on the card, ``cpu`` on the CPU."""
    from .. import __version__
    from ..device import get_device
    dev = get_device()
    if dev.type == 'cuda':
        import torch
        kind = torch.cuda.get_device_name(dev).replace(' ', '_')
    else:
        kind = 'cpu'
    return 'torch-%s:%s:v%s' % (dev.type, kind, __version__)


def _drain():
    from ..device import stream_synchronize
    stream_synchronize()


def select(name, key, candidates, make_args, n_reps=3, noise=1.10,
           n_calls=2, persist=True, strict=()):
    """Measure ``candidates`` and return (winner, ms_per_call, errors).

    name        cache-file name (one JSON per op family)
    key         shape/config signature (the backend tag is prepended)
    candidates  {impl_name: fn}; the first call of each is untimed
    make_args   () -> tuple of tensors at the ACTUAL shape
    n_calls     calls per timed repetition
    persist     False when the caller knows this measurement is
                incomplete (a candidate errored upstream): the winner is
                used this session but not written to disk
    strict      candidate names whose exception propagates instead of
                dropping the candidate: a hand-written kernel that the
                capability probe admitted must run, never be passed over

    A cached winner (in-process or on disk) is checked against the
    current candidate set: a stale name falls through to a fresh
    measurement.
    """
    full_key = '%s|%s' % (backend_tag(), key)
    fam = _cache.setdefault(name, {})
    reprobe = False
    if full_key in fam and fam[full_key][0] in candidates:
        entry = fam[full_key]
        if not _flip_spent(name, full_key, entry[1], noise):
            return entry
        del fam[full_key]            # coin-flip budget spent: re-race
        reprobe = True
    path = cache_path(name)
    disk = _read_disk(name)
    if full_key in disk and disk[full_key].get('winner') in candidates:
        if reprobe:
            # the spent entry may also sit on disk: reloading it would
            # reset the budget and serve the stale winner forever
            disk.pop(full_key, None)
        else:
            entry = (disk[full_key]['winner'],
                     disk[full_key].get('ms', {}), {})
            if not _flip_spent(name, full_key, entry[1], noise):
                fam[full_key] = entry
                return entry
            disk.pop(full_key, None)

    args = make_args()
    ms = {}
    errors = {}
    for cname, fn in candidates.items():
        try:
            fn(*args)                # first call: builds, warms
            _drain()
            best = float('inf')
            for _ in range(n_reps):
                t0 = time.perf_counter()
                for _ in range(n_calls):
                    fn(*args)
                _drain()
                best = min(best, (time.perf_counter() - t0) / n_calls)
            ms[cname] = round(best * 1e3, 3)
        except Exception as e:
            if cname in strict:
                raise
            errors[cname] = '%s: %s' % (type(e).__name__, str(e)[:120])
    if not ms:
        return (None, {}, errors)
    winner = min(ms, key=ms.get)
    entry = (winner, ms, errors)
    fam[full_key] = entry
    ranked = sorted(ms.values())
    decisive = len(ranked) < 2 or ranked[1] >= ranked[0] * noise
    if persist and not errors and decisive:
        disk[full_key] = {'winner': winner, 'ms': ms}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + '.tmp%d' % os.getpid()
            with open(tmp, 'w') as f:
                json.dump(disk, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass
    return entry
