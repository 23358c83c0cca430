"""The mean time between the visibility dumps that the sink received in
the window, from the first (which opens the clock) to the last: the
integration cadence a correlator's user sees.  Only chains whose output
is an integration of several gulps report it."""

NAME = 'dump_interval_ms'
KIND = 'end_to_end'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(ctx):
    outs = ctx.window_outputs()
    if len(outs) < 2 or \
            ctx.geom['in_frames_per_out_frame'] <= ctx.geom['gulp_nframe']:
        return None
    return 1e3 * (outs[-1][0] - outs[0][0]) / (len(outs) - 1)
