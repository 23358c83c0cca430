"""The F stage's share of its roofline: one gulp's fixed work
(roofline/fx_f.py) times the gulps of the traced sub-window, over the
summed device time of the F blocks' kernels."""

NAME = 'fx.f_roofline'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = 'F stage: blocks/fft.py, blocks/quantize.py'
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.stage_roofline('fx_f')
