"""Input complex samples (per pol and per station) that the sink received
processed in full in the window, over the time from the window's first
output to its last.  The first output opens the clock, so the samples
counted are those of the outputs after it."""

NAME = 'throughput_msps'
KIND = 'end_to_end'
UNIT = 'Msamples/s'
BETTER = 'higher'
SOURCE = 'host_clock'


def read(ctx):
    outs = ctx.window_outputs()
    if len(outs) < 2:
        return None
    per_frame = ctx.geom['in_frames_per_out_frame'] * \
        ctx.geom['samples_per_frame']
    nsamp = sum(n for _, _, n in outs[1:]) * per_frame
    return nsamp / (outs[-1][0] - outs[0][0]) / 1e6
