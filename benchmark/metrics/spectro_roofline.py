"""The spectrometer stage's share of its roofline: one gulp's fixed work
(roofline/spectrometer.py) times the gulps of the traced sub-window,
over the summed device time of the stage's kernels, whatever kernels
they are (K1, or cuFFT, K2 and the sum)."""

NAME = 'spectro_roofline'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = ('spectrometer stage: blocks/fused.py, stages.py -> '
         'ops/spectrometer.py (K1) or torch.fft + '
         'ops/gpu_kernels.stokes_detect (K2)')
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.stage_roofline('spectrometer')
