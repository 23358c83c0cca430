"""Host core pinning and NUMA memory binding (the JAX package's
``bifrost_tpu/affinity.py``; reference: src/affinity.cpp).

Pinning uses ``os.sched_setaffinity(0, ...)``, which on Linux binds the
calling thread only, so each block thread pins itself (the reference's
``bfAffinitySetCore`` is thread-scoped too).  NUMA binding reads the
node from sysfs and calls the ``mbind`` system call through libc.
Unlike the JAX module, whose NUMA calls return False or None where
binding is unavailable, these raise: a binding an operator asked for
never passes silently.
"""

from __future__ import annotations

import errno
import os

__all__ = ['get_core', 'set_core',
           'numa_node_of_core', 'bind_memory_to_node',
           'bind_memory_to_core', 'available_cores',
           'partition_cores', 'spread_cores', 'set_openmp_cores']

_MBIND_SYSCALL = {'x86_64': 237, 'aarch64': 235}
_MPOL_BIND = 2


def available_cores():
    """The cores this process may run on (its affinity mask), or every
    host core where the mask is unreadable."""
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:                  # pragma: no cover
        return list(range(os.cpu_count() or 1))


def get_core():
    """The core the calling thread is pinned to, or -1 when it may run on
    more than one."""
    try:
        cores = os.sched_getaffinity(0)
    except AttributeError:                  # pragma: no cover
        return -1
    return min(cores) if len(cores) == 1 else -1


def set_core(core):
    """Pin the calling thread to ``core`` (None or a negative core: no
    change)."""
    if core is None or core < 0:
        return
    os.sched_setaffinity(0, {int(core)})


def set_openmp_cores(cores):
    """Size the OpenMP pool: ``OMP_NUM_THREADS`` becomes the number of
    ``cores`` (a list) or ``cores`` itself (an int), as
    ``bifrost_tpu/affinity.py:68-70`` sets it."""
    os.environ['OMP_NUM_THREADS'] = str(len(cores)) \
        if not isinstance(cores, int) else str(cores)


def partition_cores(weights, cores=None):
    """Split a host core pool across tenants by weight: ``{tenant: [core,
    ...]}`` by largest remainder with one core at least each; with more
    tenants than cores, cores are shared round-robin.  ``cores`` is an
    explicit pool, else this process's affinity mask."""
    if cores is None:
        cores = available_cores()
    cores = list(cores)
    tenants = list(weights)
    if not tenants:
        return {}
    if not cores:
        return {t: [] for t in tenants}
    w = {t: max(float(weights[t] or 0), 1.0) for t in tenants}
    total = sum(w.values())
    ncore = len(cores)
    if ncore < len(tenants):
        return {t: [cores[i % ncore]] for i, t in enumerate(tenants)}
    ideal = {t: w[t] / total * ncore for t in tenants}
    share = {t: max(int(ideal[t]), 1) for t in tenants}
    while sum(share.values()) > ncore:
        victim = max((t for t in tenants if share[t] > 1),
                     key=lambda t: share[t] - ideal[t])
        share[victim] -= 1
    order = sorted(tenants, key=lambda t: (share[t] - ideal[t],
                                           tenants.index(t)))
    i = 0
    while sum(share.values()) < ncore:
        share[order[i % len(order)]] += 1
        i += 1
    out, pos = {}, 0
    for t in tenants:
        out[t] = cores[pos:pos + share[t]]
        pos += share[t]
    return out


def spread_cores(n, cores=None):
    """``n`` pin targets for a group of workers, round-robin over the
    pool (shared when the pool is smaller than ``n``)."""
    if cores is None:
        cores = available_cores()
    cores = list(cores)
    if not cores:
        return [None] * n
    return [cores[i % len(cores)] for i in range(n)]


def numa_node_of_core(core):
    """The NUMA node of a host core; raises OSError where sysfs does not
    say."""
    base = '/sys/devices/system/cpu/cpu%d' % core
    for entry in os.listdir(base):
        if entry.startswith('node') and entry[4:].isdigit():
            return int(entry[4:])
    raise OSError('no NUMA node listed for core %d under %s'
                  % (core, base))


def bind_memory_to_node(addr, nbyte, node):
    """Bind the pages of [addr, addr + nbyte) to a NUMA node with the
    ``mbind`` system call (the reference binds ring memory the same
    way, ring_impl.cpp:164-166).  Raises OSError where the call is
    unavailable or refused."""
    import ctypes
    import platform
    nr = _MBIND_SYSCALL.get(platform.machine())
    if nr is None:
        raise OSError('mbind: no system call number for %s'
                      % platform.machine())
    if not 0 <= int(node) < 8 * ctypes.sizeof(ctypes.c_ulong):
        raise OSError(errno.EINVAL, 'mbind: node %d outside the mask'
                      % node)
    if nbyte <= 0:
        return True
    libc = ctypes.CDLL(None, use_errno=True)
    page = os.sysconf('SC_PAGE_SIZE')
    start = addr & ~(page - 1)
    length = nbyte + (addr - start)
    mask = ctypes.c_ulong(1 << int(node))
    rc = libc.syscall(ctypes.c_long(nr), ctypes.c_void_p(start),
                      ctypes.c_ulong(length), ctypes.c_int(_MPOL_BIND),
                      ctypes.byref(mask),
                      ctypes.c_ulong(8 * ctypes.sizeof(mask) + 1),
                      ctypes.c_uint(0))
    if rc != 0:
        err = ctypes.get_errno()
        raise OSError(err, 'mbind to node %d: %s' % (node,
                                                     os.strerror(err)))
    return True


def bind_memory_to_core(array, core):
    """Bind a numpy buffer to the NUMA node of ``core`` (an int, or a
    list whose first entry counts)."""
    if isinstance(core, (list, tuple)):
        if not core:
            raise ValueError('no core given')
        core = core[0]
    return bind_memory_to_node(array.ctypes.data, array.nbytes,
                               numa_node_of_core(core))
