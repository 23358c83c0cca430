"""Share of the traced sub-window with a kernel (or a device-side
memset or copy within the card) running."""

NAME = 'device.kernel_share'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = 'device'
MOVES = 'throughput_msps'


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace['by_kind_s']['kernel'] / \
        ctx.trace['window_s']
