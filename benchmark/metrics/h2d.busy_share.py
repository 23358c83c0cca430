"""Share of the traced sub-window with a host-to-device copy on the
card: the union of the profiler's HtoD memcpy intervals."""

NAME = 'h2d.busy_share'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = 'H2D: blocks/copy.py -> xfer.TransferEngine.to_device_direct'
MOVES = 'throughput_msps'


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace['by_kind_s']['h2d'] / ctx.trace['window_s']
