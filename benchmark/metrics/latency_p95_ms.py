"""95th percentile over the window's outputs of the sink's receipt time
(after the output's D2H completed) less the creation stamp the source
gave the newest input gulp the output covers.  In a closed loop at
saturation it reads how many gulps the rings hold behind the slower
PCIe direction, times one gulp's period, so it is a reading of the
runtime's queueing and not a tail a user sees.  Read only where an
output covers at most one input gulp (an integration over many gulps
would put its own length into the age), and not below 200 outputs,
where the percentile would rest on fewer than ten beyond it."""

import math

NAME = 'latency_p95_ms'
KIND = 'per_layer'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
LAYER = 'runtime: pipeline.py, ring.py'
MOVES = 'throughput_msps'

MIN_OUTPUTS = 200


def latencies_s(ctx):
    g = ctx.geom
    out = []
    for t, off, n in ctx.window_outputs():
        newest = ((off + n) * g['in_frames_per_out_frame'] - 1) // \
            g['gulp_nframe']
        out.append(t - ctx.stamps[newest])
    return out


def read(ctx):
    if ctx.geom['in_frames_per_out_frame'] > ctx.geom['gulp_nframe']:
        return None
    lat = sorted(latencies_s(ctx))
    if len(lat) < MIN_OUTPUTS:
        return None
    return 1e3 * lat[int(math.ceil(0.95 * len(lat))) - 1]
