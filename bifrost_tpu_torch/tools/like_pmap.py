"""pmap-style memory map of a bifrost_tpu_torch pipeline process (the
port's counterpart of ``tools/like_pmap.py``).

Reads the pipeline's ring geometry from its rings/<name> ProcLogs and
the process address space from /proc/<pid>/numa_maps, classifies the
memory areas (file-backed vs anonymous, heap/stack/huge/shared/
swapped, NUMA node binding), matches each ring to its best-fit
anonymous area, and reports per-NUMA-node totals plus per-ring mapping
details — the reference tool's full information set.
"""

import argparse
import os
import re
import subprocess
import sys


from .. import proclog
from ..monitor_utils import get_best_size, ring_geometry


_NODE_RE = re.compile(r'^N(\d+)=(\d+)$')


def _page_sizes():
    page = 4096
    huge = 2 * 1024 * 1024
    try:
        page = int(subprocess.check_output(['getconf', 'PAGESIZE']), 10)
    except (subprocess.CalledProcessError, ValueError, OSError):
        pass
    try:
        with open('/proc/meminfo') as f:
            for line in f:
                if line.startswith('Hugepagesize:'):
                    huge = int(line.split()[1], 10) * 1024
                    break
    except (OSError, ValueError):
        pass
    return page, huge


def load_numa_maps(pid, page, huge_page):
    """Parse /proc/<pid>/numa_maps into file-backed and anonymous area
    dicts (reference: like_pmap.py:84-155)."""
    files, areas = {}, {}
    try:
        with open('/proc/%d/numa_maps' % pid) as fh:
            lines = fh.read().split('\n')
    except OSError:
        return files, areas
    for line in lines:
        is_file = line.find('file=') != -1
        is_anon = line.find('anon=') != -1
        if not (is_file or is_anon):
            continue
        tokens = line.split()
        if not tokens:
            continue
        addr = tokens[0]
        huge = 'huge' in line
        scale = huge_page if huge else page
        # pages may be spread over several NUMA nodes (N0=.. N1=..):
        # total them for the size; bind the area to its largest node.
        # Swapped-out pages appear as swapcache=<pages>.
        node_pages, swap_pages = {}, 0
        for tok in tokens[1:]:
            m = _NODE_RE.match(tok)
            if m:
                node_pages[int(m.group(1))] = \
                    node_pages.get(int(m.group(1)), 0) + \
                    int(m.group(2), 10)
            elif tok.startswith('swapcache='):
                try:
                    swap_pages = int(tok.split('=', 1)[1], 10)
                except ValueError:
                    pass
        if not node_pages and not swap_pages:
            continue
        entry = {
            # a fully swapped-out area has no resident N<node>= counts;
            # size it by its swapcache pages and park it on node -1
            'size': (sum(node_pages.values()) or swap_pages) * scale,
            'node': max(node_pages, key=node_pages.get)
                    if node_pages else -1,
            'huge': huge,
            'heap': 'heap' in line,
            'stack': 'stack' in line,
            'shared': 'mapmax=' in line,
            'swapped': swap_pages > 0,
            'swapsize': swap_pages * scale,
        }
        (files if is_file else areas)[addr] = entry
    return files, areas


def load_rings(pid):
    """Ring geometry from the rings/<name> ProcLogs."""
    return ring_geometry(proclog.load_by_pid(pid))


def node_totals(table):
    counts, sizes = {}, {}
    for entry in table.values():
        node = entry['node']
        counts[node] = counts.get(node, 0) + 1
        sizes[node] = sizes.get(node, 0) + entry['size']
    return counts, sizes


def _area_summary(label, table):
    out = ['%s:' % label,
           '  Total: %i' % len(table),
           '  Heap: %i' % sum(e['heap'] for e in table.values()),
           '  Stack: %i' % sum(e['stack'] for e in table.values()),
           '  Shared: %i' % sum(e['shared'] for e in table.values()),
           '  Swapped: %i' % sum(e['swapped'] for e in table.values())]
    counts, sizes = node_totals(table)
    for node in sorted(counts):
        out.append('  NUMA Node %i:' % node)
        out.append('    Count: %i' % counts[node])
        out.append('    Size: %.3f %s' % get_best_size(sizes[node]))
    return out


def report(pid):
    page, huge = _page_sizes()
    rings = load_rings(pid)
    files, areas = load_numa_maps(pid, page, huge)

    # best-fit ring -> anonymous area matching
    # (reference: like_pmap.py:156-168)
    matched = []
    for name, dtl in rings.items():
        stride = float(dtl.get('stride', 0)) * \
            max(int(dtl.get('nringlet', 1)), 1)
        dtl['bytes'] = stride
        dtl['addr'] = None
        if dtl.get('space') not in (None, 'system', 'cuda_host'):
            continue     # device-resident; not in the host map
        best, metric = None, float('inf')
        for addr, entry in areas.items():
            diff = abs(entry['size'] - stride)
            if diff < metric:
                best, metric = addr, diff
        dtl['addr'] = best
        if best is not None:
            matched.append(best)

    out = ['Rings: %i' % len(rings)]
    out += _area_summary('File Backed Memory Areas', files)
    out += _area_summary('Anonymous Memory Areas', areas)
    out.append('')
    out.append('Ring Mappings:')
    for name in sorted(rings):
        dtl = rings[name]
        out.append('  %s' % name)
        out.append('    Space: %s' % dtl.get('space', '?'))
        out.append('    Size: %.3f %s' % get_best_size(dtl['bytes']))
        if dtl.get('space') not in (None, 'system', 'cuda_host'):
            out.append('    Area: (device-resident; not in the host '
                       'address space)')
            continue
        area = areas.get(dtl.get('addr'))
        if area is None:
            out.append('    Area: Unknown')
            continue
        diff = abs(area['size'] - dtl['bytes'])
        status = ' ???' if diff > 0.5 * huge else ''
        out.append('    Area: %s%s' % (dtl['addr'], status))
        sv, su = get_best_size(area['size'])
        if diff:
            dv, du = get_best_size(diff)
            out.append('      Size: %.3f %s (within %.3f %s)'
                       % (sv, su, dv, du))
        else:
            out.append('      Size: %.3f %s' % (sv, su))
        out.append('      Node: %i' % area['node'])
        out.append('      Attributes:')
        out.append('        Huge? %s' % area['huge'])
        out.append('        Heap? %s' % area['heap'])
        out.append('        Stack? %s' % area['stack'])
        out.append('        Shared? %s' % area['shared'])
        out.append('      Swap Status:')
        out.append('        Swapped? %s' % area['swapped'])
        if area['swapped'] and area['size']:
            out.append('        Swap Fraction: %.1f%%'
                       % (100.0 * area['swapsize'] / area['size']))
    out.append('')
    other = sum(e['size'] for a, e in areas.items() if a not in matched)
    out.append('Other Non-Ring Areas:')
    out.append('  Size: %.3f %s' % get_best_size(other))
    out.append('')
    out.append('File Backed Areas:')
    out.append('  Size: %.3f %s'
               % get_best_size(sum(e['size'] for e in files.values())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('pid', nargs='?', type=int,
                    help='pipeline PID (default: first found)')
    args = ap.parse_args(argv)
    pid = args.pid
    if pid is None:
        base = proclog.proclog_dir()
        pids = sorted(int(p) for p in os.listdir(base)
                      if p.isdigit()) if os.path.isdir(base) else []
        if not pids:
            print('No running pipelines found under %s' % base)
            return 1
        pid = pids[0]
    for line in report(pid):
        print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
