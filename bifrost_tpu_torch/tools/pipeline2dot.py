"""Reconstruct a running pipeline's block/ring graph from its ProcLogs
and emit graphviz DOT (the port's counterpart of
``tools/pipeline2dot.py``).

Annotations matching the reference's information set:
  * graph label with the pipeline's command line
  * block shapes by role (source=ellipse, sink=diamond, transform=box)
    and CPU binding ("CPU3" / "Unbound") in each block label
  * ring nodes annotated with space, size, and nringlet from the
    rings/<name> geometry ProcLogs
  * edge labels with the stream dtype where a sequence ProcLog
    records one
  * producer->ring edges labeled with occupancy % and gulps/s from the
    rings_flow/<name> ProcLogs the telemetry exporter publishes,
    so the graph doubles as a bottleneck map
    (a full ring ahead of a slow block shows up immediately); ring
    wait p99 is appended when the exporter recorded one
  * BridgeSink/BridgeSource rendered as CROSS-HOST boundary nodes
    (cds shape, gold fill, labeled with role + peer address) annotated
    with the live bridge tx/rx byte totals, rates, and reconnect
    counts from the ``<block>_bridge_transmit|capture/stats`` entries
    the transport publishes — the inter-host hop
    is visible in the graph, not disguised as an ordinary block
  * dotted bidirectional association edges between blocks bound to the
    same core (reference: pipeline2dot.py:188-219)
  * compiled pipeline segments (bifrost_tpu_torch.segments)
    rendered as ONE dashed cluster per segment: the member blocks
    grouped with the segment node, the elided interior rings dashed +
    grayed, the cluster labeled with the live dispatches-per-gulp
    from the segment's perf key — fusion is visible instead of
    looking like a chain of dead blocks
  * static-verifier diagnostics (bifrost_tpu_torch.analysis.verify,
    published to the ``analysis/verify`` ProcLog by BF_VALIDATE=warn|strict)
    overlaid on the graph: rings/edges carrying a BF-E render red,
    BF-W amber, with the code + message as the node/edge tooltip — the
    bottleneck map doubles as a config-review map
"""

import argparse
import json
import os
import re
import sys

from .. import proclog
from ..monitor_utils import (get_best_size, get_command_line, ring_geometry)


def _is_ring_entry(block):
    return block.replace(os.sep, '/').startswith('rings')



def get_data_flows(contents):
    """block -> ([in rings], [out rings]); also classify sources/sinks
    (reference: pipeline2dot.py:97-136)."""
    flows, sources, sinks = {}, [], []
    for block, logs in contents.items():
        if _is_ring_entry(block):
            continue
        rins, routs = [], []
        found = False
        for log, dest in (('in', rins), ('out', routs)):
            d = logs.get(log, {})
            for key in sorted(d):
                if key.startswith('ring'):
                    found = True
                    if d[key] not in dest:
                        dest.append(d[key])
        flows[block] = (rins, routs)
        if found and not rins:
            sources.append(block)
        if found and not routs:
            sinks.append(block)
    return flows, sources, sinks


_DTYPE_RE = re.compile(r"'dtype':\s*'([^']+)'")


def stream_dtype(logs):
    """dtype recorded by a block's sequence ProcLogs, if any
    (reference reads nbit/complex from sequence logs,
    pipeline2dot.py:160-168)."""
    for name, d in logs.items():
        if not name.startswith('sequence'):
            continue
        if 'dtype' in d:
            return str(d['dtype'])
        tensor = d.get('_tensor')
        if isinstance(tensor, str):
            m = _DTYPE_RE.search(tensor)
            if m:
                return m.group(1)
    return None


def core_associations(contents):
    """Pairs of blocks bound to a common core
    (reference: pipeline2dot.py:188-219)."""
    cores = {}
    for block, logs in contents.items():
        if _is_ring_entry(block):
            continue
        bound = []
        i = 0
        while 'core%i' % i in logs.get('bind', {}):
            bound.append(logs['bind']['core%i' % i])
            i += 1
        if bound:
            cores[block] = set(bound)
    pairs = []
    names = sorted(cores)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            if cores[a] & cores[b] and cores[a] != {-1}:
                pairs.append((a, b))
    return pairs


#: suffixes of the transport's stats ProcLog directories — these are
#: per-endpoint telemetry attachments, not pipeline blocks
_BRIDGE_STAT_SUFFIXES = ('_bridge_transmit', '_bridge_capture')


def bridge_info(contents):
    """{block: {'role': 'sink'|'source', 'peer': 'addr:port'}} from
    the ``<block>/bridge`` ProcLogs the bridge blocks publish."""
    out = {}
    for block, logs in contents.items():
        if _is_ring_entry(block):
            continue
        b = logs.get('bridge')
        if isinstance(b, dict) and b.get('role'):
            out[block] = {'role': str(b['role']),
                          'peer': str(b.get('peer', '?'))}
    return out


def bridge_stats(contents, block):
    """The transport's live stats for a bridge block: tx or rx bytes,
    rate, and reconnect/dup counts from its ``*_bridge_transmit`` /
    ``*_bridge_capture`` stats entry (whichever exists)."""
    for suffix, kind in (('_bridge_transmit', 'tx'),
                         ('_bridge_capture', 'rx')):
        logs = contents.get(block + suffix)
        if not logs:
            continue
        stats = logs.get('stats', {})
        if not stats:
            continue
        nbytes = stats.get('nbytes', stats.get('ngood_bytes', 0))
        out = {'kind': kind, 'nbytes': int(float(nbytes or 0)),
               'rate_MBps': float(stats.get('rate_MBps', 0) or 0)}
        if kind == 'tx':
            out['reconnects'] = int(float(stats.get('reconnects', 0)
                                          or 0))
            out['nspans'] = int(float(stats.get('nspans', 0) or 0))
        else:
            out['dups'] = int(float(stats.get('nignored', 0) or 0))
        return out
    return None


def bridge_label(info, stats):
    """Boundary-node label lines under the block name."""
    parts = ['bridge %s <-> %s' % (info['role'], info['peer'])]
    if stats:
        sz, un = get_best_size(stats['nbytes'])
        line = '%s %.1f %s' % (stats['kind'], sz, un)
        if stats.get('rate_MBps'):
            line += ' @ %.1f MB/s' % stats['rate_MBps']
        parts.append(line)
        if stats.get('reconnects'):
            parts.append('%d reconnect(s)' % stats['reconnects'])
        if stats.get('dups'):
            parts.append('%d dup(s) dropped' % stats['dups'])
    return '\\n'.join(parts)


def segment_info(contents):
    """{segment block: {'members': [...], 'elided': [...], 'split':
    n, 'dpg': dispatches-per-gulp}} from the ``<block>/segment``
    ProcLogs compiled segments publish (bifrost_tpu_torch.segments) plus
    the live ``segment_dispatches_per_gulp`` perf key.  pipeline2dot
    renders each as ONE cluster: the member blocks grouped with the
    segment node, the elided interior rings dashed — the graph shows
    the fusion instead of a chain of apparently-dead blocks."""
    out = {}
    for block, logs in contents.items():
        if _is_ring_entry(block):
            continue
        seg = logs.get('segment')
        if not isinstance(seg, dict) or 'members' not in seg:
            continue
        perf = logs.get('perf', {})
        try:
            dpg = float(perf.get('segment_dispatches_per_gulp', 0))
        except (TypeError, ValueError):
            dpg = 0.0
        out[block] = {
            'members': [m for m in
                        str(seg.get('members', '')).split(',') if m],
            'elided': [r for r in
                       str(seg.get('elided', '')).split(',') if r],
            'split': int(float(seg.get('split', 0) or 0)),
            'dpg': dpg,
        }
    return out


def ring_flow(contents):
    """rings_flow/<name> ProcLogs -> {ring_name: fields} (published by
    telemetry.exporter.MetricsPublisher)."""
    out = {}
    for block, logs in contents.items():
        norm = block.replace(os.sep, '/')
        if norm == 'rings_flow':
            out.update({k: dict(v) for k, v in logs.items()})
        elif norm.startswith('rings_flow/'):
            name = norm.split('/', 1)[1]
            for fields in logs.values():
                out[name] = dict(fields)
    return out


def flow_label(flow):
    """Edge-label text for one ring's flow entry ('' when idle)."""
    if not flow:
        return ''
    parts = []
    if 'occupancy_pct' in flow:
        parts.append('%.0f%% full' % float(flow['occupancy_pct']))
    if flow.get('gulps_per_s'):
        parts.append('%.1f gulps/s' % float(flow['gulps_per_s']))
    elif 'gulps' in flow:
        parts.append('%d gulps' % int(flow['gulps']))
    wait = flow.get('reserve_wait_p99_ms')
    if wait:
        parts.append('p99 wait %.1fms' % float(wait))
    return '\\n'.join(parts)


def verifier_diags(contents):
    """Diagnostics published to the ``analysis/verify`` ProcLog
    (bifrost_tpu_torch.analysis.verify.publish_diagnostics): two maps,
    {block_name: [diag]} and {ring_name: [diag]}."""
    by_block, by_ring = {}, {}
    for block, logs in contents.items():
        if block.replace(os.sep, '/') != 'analysis':
            continue
        entry = logs.get('verify', {})
        diag_keys = (k for k in entry
                     if k.startswith('diag') and k[4:].isdigit())
        for key in sorted(diag_keys, key=lambda k: int(k[4:])):
            try:
                d = json.loads(str(entry[key]))
            except (ValueError, TypeError):
                continue
            if not isinstance(d, dict) or 'code' not in d:
                continue
            if d.get('block'):
                by_block.setdefault(str(d['block']), []).append(d)
            if d.get('ring'):
                by_ring.setdefault(str(d['ring']), []).append(d)
    return by_block, by_ring


#: severity -> (edge/border color, node fill) for the diagnostic
#: overlay; errors dominate warnings, info is not rendered
_DIAG_STYLE = {'error': ('red', 'lightsalmon'),
               'warning': ('orange2', 'navajowhite')}


def _diag_overlay(diags):
    """(color, fill, tooltip) for a node/edge carrying ``diags``, or
    None when only info-level findings are present."""
    worst = None
    for d in diags:
        sev = d.get('severity')
        if sev == 'error':
            worst = 'error'
            break
        if sev == 'warning':
            worst = 'warning'
    if worst is None:
        return None
    color, fill = _DIAG_STYLE[worst]
    tooltip = ' | '.join(
        '%s: %s' % (d.get('code'), d.get('message'))
        for d in diags if d.get('severity') != 'info')
    return color, fill, tooltip.replace('"', "'")


def to_dot(pid, contents, associations=True):
    flows, sources, sinks = get_data_flows(contents)
    geometry = ring_geometry(contents)
    ring_flows = ring_flow(contents)
    bridges = bridge_info(contents)
    segments = segment_info(contents)
    diag_blocks, diag_rings = verifier_diags(contents)
    cmd = get_command_line(pid)
    if cmd.startswith('python'):
        cmd = cmd.split(None, 1)[-1]
    cmd = os.path.basename(cmd.split(None, 1)[0]) if cmd else ''

    # compiled-segment membership: member blocks and elided interior
    # rings render INSIDE their segment's cluster (dashed border); a
    # block name may be stored with or without the pipeline prefix,
    # so membership matches on the trailing path component too
    seg_of_block, seg_of_ring = {}, {}
    for seg, info in segments.items():
        seg_of_block[seg] = seg
        for m in info['members']:
            seg_of_block[m] = seg
            seg_of_block[m.split('/')[-1]] = seg
        for r in info['elided']:
            seg_of_ring[r] = seg

    def _block_segment(block):
        return seg_of_block.get(block) or \
            seg_of_block.get(block.split('/')[-1])

    lines = ['digraph graph%d {' % pid,
             '  rankdir=LR;',
             '  labelloc="t";',
             '  label="Pipeline: %s\\n ";' % cmd]
    cluster_nodes = {seg: [] for seg in segments}

    def emit_node(line, block=None, ring=None):
        seg = _block_segment(block) if block is not None \
            else seg_of_ring.get(ring)
        if seg in cluster_nodes:
            cluster_nodes[seg].append(line)
        else:
            lines.append(line)

    rings = set()
    for block, (ins, outs) in sorted(flows.items()):
        # the transport's per-endpoint stats directories are telemetry
        # attachments of a bridge block, not pipeline blocks
        if block.endswith(_BRIDGE_STAT_SUFFIXES):
            continue
        logs = contents[block]
        core = logs.get('bind', {}).get('core0', None)
        cpu = 'Unbound' if core in (None, -1) else 'CPU%s' % core
        if block in bridges:
            # cross-host boundary node: the stream leaves/enters this
            # process here — annotate with the live transport figures
            info = bridges[block]
            stats = bridge_stats(contents, block)
            emit_node('  "%s" [label="%s\\n%s\\n%s" shape="cds" '
                      'style=filled fillcolor=lightgoldenrod];'
                      % (block, block, cpu,
                         bridge_label(info, stats)), block=block)
        else:
            shape = 'ellipse' if block in sources else \
                'diamond' if block in sinks else 'box'
            overlay = _diag_overlay(diag_blocks.get(block, ()))
            if overlay is not None:
                # verifier finding on this block: tinted fill + a
                # colored border, tooltip carries code + message
                color, fill, tip = overlay
                emit_node('  "%s" [label="%s\\n%s" shape="%s" '
                          'style=filled fillcolor=%s color=%s '
                          'penwidth=2 tooltip="%s"];'
                          % (block, block, cpu, shape, fill,
                             color, tip), block=block)
            else:
                emit_node('  "%s" [label="%s\\n%s" shape="%s" '
                          'style=filled fillcolor=lightsteelblue];'
                          % (block, block, cpu, shape), block=block)
        # sequence proclogs record the block's INPUT header
        # (pipeline.py MultiTransformBlock.main), so the dtype label
        # belongs on the input edges only
        dtype = stream_dtype(logs)

        def edge_attrs(r, label):
            attrs = []
            if label:
                attrs.append('label="%s"' % label)
            overlay = _diag_overlay(diag_rings.get(str(r), ()))
            if overlay is not None:
                color, _fill, tip = overlay
                attrs.append('color=%s penwidth=2 tooltip="%s"'
                             % (color, tip))
            return ' [%s]' % ' '.join(attrs) if attrs else ''

        for r in ins:
            rings.add(r)
            lines.append('  "ring:%s" -> "%s"%s;'
                         % (r, block, edge_attrs(r, dtype or '')))
        for r in outs:
            rings.add(r)
            fl = flow_label(ring_flows.get(str(r), {}))
            lines.append('  "%s" -> "ring:%s"%s;'
                         % (block, r, edge_attrs(r, fl)))
    for r in sorted(rings):
        dtl = geometry.get(str(r), {})
        if 'stride' in dtl:
            sz, un = get_best_size(
                float(dtl['stride']) *
                max(int(dtl.get('nringlet', 1)), 1))
            extra = '\\n%s  %.1f %s' % (dtl.get('space', '?'), sz, un)
            nringlet = int(dtl.get('nringlet', 1))
            if nringlet > 1:
                extra += '  x%d ringlets' % nringlet
        else:
            extra = ''
        if str(r) in seg_of_ring:
            # elided interior ring of a compiled segment: still shown
            # (the topology is real) but dashed + grayed — no span
            # ever flows through it while the segment is fused
            emit_node('  "ring:%s" [label="%s%s\\n(elided)" '
                      'shape=ellipse style=dashed color=gray50 '
                      'fontcolor=gray50];' % (r, r, extra),
                      ring=str(r))
        else:
            lines.append('  "ring:%s" [label="%s%s" shape=ellipse];'
                         % (r, r, extra))
    # compiled-segment clusters (bifrost_tpu_torch.segments): one dashed box
    # around the segment node, its member blocks, and the elided
    # interior rings, labeled with the LIVE dispatch amortization from
    # the segment's perf proclog.  Graphviz assigns a
    # node to the FIRST (sub)graph that mentions it, and the edge
    # statements above already name the member/ring nodes at the root
    # — so the cluster subgraphs must be INSERTED before every edge,
    # right after the graph header, or they render as empty boxes
    cluster_lines = []
    for i, (seg, info) in enumerate(sorted(segments.items())):
        label = 'compiled segment (%d blocks' % len(info['members'])
        if info.get('split'):
            label += ', split %d' % info['split']
        label += ')'
        if info.get('dpg'):
            label += '\\n%.4g dispatches/gulp' % info['dpg']
        cluster_lines.append('  subgraph cluster_segment_%d {' % i)
        cluster_lines.append('    label="%s";' % label)
        cluster_lines.append('    style=dashed; color=steelblue; '
                             'fontcolor=steelblue;')
        for node in cluster_nodes.get(seg, []):
            cluster_lines.append('  ' + node)
        cluster_lines.append('  }')
    lines[4:4] = cluster_lines
    if associations:
        for a, b in core_associations(contents):
            lines.append('  "%s" -> "%s" [style="dotted" dir="both"];'
                         % (a, b))
    lines.append('}')
    return '\n'.join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('pid', nargs='?', type=int,
                    help='pipeline PID (default: first found)')
    ap.add_argument('-n', '--no-associations', action='store_true',
                    help='exclude same-core association edges')
    args = ap.parse_args(argv)
    pid = args.pid
    if pid is None:
        base = proclog.proclog_dir()
        pids = sorted(int(p) for p in os.listdir(base)
                      if p.isdigit()) if os.path.isdir(base) else []
        if not pids:
            print('No running pipelines found', file=sys.stderr)
            return 1
        pid = pids[0]
    print(to_dot(pid, proclog.load_by_pid(pid),
                 associations=not args.no_associations))
    return 0


if __name__ == '__main__':
    sys.exit(main())
