"""Fusable device-block stages.

A Stage is the pure core of a device TransformBlock, split in two halves
(as in ``bifrost_tpu/stages.py``):

- ``transform_header(hdr) -> ohdr``: per-sequence metadata negotiation
- ``build(in_meta) -> fn``: the function of one gulp, where ``in_meta``
  describes the device-representation input tensor

:class:`bifrost_tpu_torch.blocks.fused.FusedBlock` composes a chain of
stages with :func:`compose_stages`, which substitutes a hand-written
whole-chain CUDA kernel where the chain matches one
(:func:`match_spectrometer`, :func:`match_beamformer`).  The port carries
the stages of the Guppi spectrometer chain (FFT, detect and reduce in
every mode and op of the JAX package), the data-movement stages
(:class:`FftShiftStage`, :class:`ReverseStage`, :class:`ScrunchStage`,
:class:`TransposeStage`), the coherent beamformer chain
(:class:`BeamformStage`, detect, the frame-axis sum), the FX correlator
(FFT, :class:`QuantizeStage`, :class:`CorrelateStage`,
:class:`AccumulateStage`) and the FRB search (:class:`FdmtStage`,
:class:`MatchedFilterStage`, :class:`ThresholdStage`, with
:func:`chain_overlap_nframe`) and :class:`MapStage`, a user's bf.map
expression as a stage.
"""

from __future__ import annotations

from copy import deepcopy
from functools import reduce as _reduce

from .dtype import DataType
from .units import convert_units, transform_units

__all__ = ['Stage', 'FftStage', 'DetectStage', 'ReduceStage',
           'FftShiftStage', 'ReverseStage', 'ScrunchStage', 'TransposeStage', 'BeamformStage', 'QuantizeStage',
           'CorrelateStage', 'AccumulateStage', 'MapStage', 'FdmtStage',
           'MatchedFilterStage', 'ThresholdStage', 'chain_overlap_nframe',
           'SpectrometerPlan', 'walk_headers', 'compose_stages',
           'match_spectrometer', 'match_beamformer']


class Stage(object):
    """Base class; transform_header is called once per sequence, before
    build."""

    #: (num, den): output_nframe = input_nframe * num // den
    nframe_ratio = (1, 1)

    #: Time-concat equivariance: applying the stage to K gulps stacked
    #: along the time axis equals applying it per gulp and concatenating.
    #: Every ported stage has it; a user-defined stage defaults to False.
    #: The port keeps the flag for its macro-gulp slice, which reads it.
    batch_safe = False

    #: Frames of future input (lookahead) each output frame may read:
    #: output frame t depends on input frames [t, t + overlap_nframe].  A
    #: wrapping block advertises it as its ring overlap
    #: (``define_input_overlap_nframe``).
    overlap_nframe = 0

    def transform_header(self, hdr):
        return hdr

    def build(self, in_meta):
        """in_meta: dict(shape=device-rep shape incl. frame axis,
        dtype=DataType, reim=bool).  Return fn(tensor) -> tensor in
        device representation."""
        raise NotImplementedError

    def output_nframe(self, input_nframe):
        num, den = self.nframe_ratio
        if (input_nframe * num) % den:
            raise ValueError("%s: nframe %d not divisible by %d"
                             % (type(self).__name__, input_nframe, den))
        return input_nframe * num // den


def _complexify_fn(in_meta):
    """Stage-input helper: ci device rep (int (re, im) pairs) ->
    complex64."""
    reim = in_meta.get('reim', False)

    def fn(x):
        if reim and not x.is_complex():
            import torch
            return torch.complex(x[..., 0].float(), x[..., 1].float())
        return x
    return fn


def _resolve_axis(tensor, axis):
    if isinstance(axis, str):
        return tensor['labels'].index(axis)
    return axis


class FftStage(Stage):
    """FFT over named axes (reference: blocks/fft.py:39-137; src/fft.cu;
    ``bifrost_tpu/stages.py:103-193``): c2c forward or inverse, r2c from
    real input, c2r when ``real_output``, each optionally fftshifted.  The
    inverse and c2r are unnormalized, as cuFFT's are."""

    batch_safe = True

    def __init__(self, axes, inverse=False, real_output=False,
                 axis_labels=None, apply_fftshift=False):
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        if not isinstance(axis_labels, (list, tuple)):
            axis_labels = [axis_labels]
        self.specified_axes = list(axes)
        self.inverse = inverse
        self.real_output = real_output
        self.axis_labels = list(axis_labels)
        self.apply_fftshift = apply_fftshift

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        itype = DataType(itensor['dtype']).as_floating_point()
        self.axes = [_resolve_axis(itensor, ax)
                     for ax in self.specified_axes]
        axes = self.axes
        shape = [itensor['shape'][ax] for ax in axes]
        otype = itype.as_real() if self.real_output else itype.as_complex()
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = str(otype)
        self.itype, self.otype = itype, otype
        self.mode = ('r2c' if itype.is_real and otype.is_complex else
                     'c2r' if itype.is_complex and otype.is_real else 'c2c')
        if itensor['shape'].index(-1) in axes:
            raise KeyError("Cannot transform the frame axis; reshape the "
                           "stream first (views.split_axis)")
        if self.mode == 'r2c':
            otensor['shape'][axes[-1]] = otensor['shape'][axes[-1]] // 2 + 1
        elif self.mode == 'c2r':
            otensor['shape'][axes[-1]] = (otensor['shape'][axes[-1]] - 1) * 2
            shape[-1] = (shape[-1] - 1) * 2
        for i, (ax, length) in enumerate(zip(axes, shape)):
            if 'units' in otensor:
                otensor['units'][ax] = transform_units(
                    otensor['units'][ax], -1)
            if 'scales' in otensor:
                otensor['scales'][ax][0] = 0
                otensor['scales'][ax][1] = \
                    1. / (otensor['scales'][ax][1] * length)
            if 'labels' in otensor and self.axis_labels != [None]:
                otensor['labels'][ax] = self.axis_labels[i]
        self._oshape_tpl = list(otensor['shape'])
        return ohdr

    def build(self, in_meta):
        import torch
        from .ops.fft import fftn_dispatch
        pre = _complexify_fn(in_meta)
        axes = list(self.axes)
        mode, shift, inverse = self.mode, self.apply_fftshift, self.inverse
        odt = self.otype.as_torch_dtype()
        rdt = torch.float64 if self.itype.nbits > 32 else torch.float32
        oshape_tpl = self._oshape_tpl

        def fn(x):
            x = pre(x)
            if mode == 'r2c':
                x = (x.real if x.is_complex() else x).to(rdt)
                y = torch.fft.rfftn(x, dim=axes)
                if shift:
                    y = torch.fft.fftshift(y, dim=axes)
            elif mode == 'c2r':
                if shift:
                    x = torch.fft.ifftshift(x, dim=axes)
                sizes = [oshape_tpl[a] if oshape_tpl[a] != -1
                         else x.shape[a] for a in axes]
                y = torch.fft.irfftn(x, s=sizes, dim=axes, norm='forward')
            elif inverse:
                if shift:
                    x = torch.fft.ifftshift(x, dim=axes)
                y = fftn_dispatch(x, axes, inverse=True)
            else:
                y = fftn_dispatch(x, axes)
                if shift:
                    y = torch.fft.fftshift(y, dim=axes)
            return y.to(odt)
        return fn


class DetectStage(Stage):
    """Square-law detection (reference: blocks/detect.py:40-138;
    ``bifrost_tpu/stages.py:194-284``), modes 'scalar', 'jones',
    'stokes', 'stokes_i' and 'coherence'.

    Stokes over pol axis 1 of a (time, pol, freq) stream runs the K2
    kernel (:func:`bifrost_tpu_torch.ops.gpu_kernels.stokes_detect`)
    whenever the shape matches; the JAX package uses its Pallas kernel
    there only under ``BF_USE_PALLAS`` (``stages.py:263``)."""

    batch_safe = True

    def __init__(self, mode, axis=None):
        self.mode = mode.lower()
        self.axis = axis
        if self.mode not in ('scalar', 'jones', 'stokes', 'stokes_i',
                             'coherence'):
            raise ValueError("Invalid detect mode: %r" % mode)

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        itype = DataType(itensor['dtype'])
        if not itype.is_complex:
            raise TypeError("detect requires complex input")
        axis = self.axis
        if axis is None and self.mode != 'scalar':
            axis = 'pol'
        if isinstance(axis, str):
            axis = itensor['labels'].index(axis)
        self.axis_index = axis
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        if axis is not None:
            self.npol = otensor['shape'][axis]
            if self.npol not in (1, 2):
                raise ValueError("Polarization axis must have length 1 or 2")
            if self.mode in ('stokes', 'coherence') and self.npol == 2:
                otensor['shape'][axis] = 4
            if self.mode == 'stokes_i' and self.npol == 2:
                otensor['shape'][axis] = 1
            if 'labels' in otensor:
                otensor['labels'][axis] = 'pol'
        else:
            self.npol = 1
        otype = itype if (self.mode == 'jones' and self.npol == 2) \
            else itype.as_real()
        otensor['dtype'] = str(otype.as_floating_point())
        self.otype = DataType(otensor['dtype'])
        return ohdr

    def build(self, in_meta):
        import torch
        from .ops import gpu_kernels
        pre = _complexify_fn(in_meta)
        mode, axis, npol = self.mode, self.axis_index, self.npol
        odt = self.otype.as_torch_dtype()

        def mag2(v):
            return v.real * v.real + v.imag * v.imag

        def fn(x):
            x = pre(x)
            if npol == 1:
                return mag2(x).to(odt)
            if mode == 'stokes' and axis == 1 and x.dim() == 3 and \
                    odt == torch.float32 and x.dtype == torch.complex64:
                v = torch.view_as_real(x)           # (T, 2, F, 2)
                return gpu_kernels.stokes_detect(v[:, 0, :, 0],
                                                 v[:, 0, :, 1],
                                                 v[:, 1, :, 0],
                                                 v[:, 1, :, 1])
            xp, yp = x.select(axis, 0), x.select(axis, 1)
            xx, yy = mag2(xp), mag2(yp)
            if mode == 'stokes_i':
                out = [xx + yy]
            elif mode == 'stokes':
                xyr = xp.real * yp.real + xp.imag * yp.imag
                xyi = xp.imag * yp.real - xp.real * yp.imag
                out = [xx + yy, xx - yy, 2 * xyr, -2 * xyi]
            elif mode == 'coherence':
                # conj(x) * y
                out = [xx, yy, xp.real * yp.real + xp.imag * yp.imag,
                       xp.real * yp.imag - xp.imag * yp.real]
            elif mode == 'jones':
                out = [torch.complex(xx, yy), xp * yp.conj()]
            else:
                raise ValueError(mode)
            return torch.stack(out, dim=axis).to(odt)
        return fn


class ReduceStage(Stage):
    """Reduce adjacent elements of an axis in groups of ``factor`` with
    ``op`` (sum, mean, min, max, stderr and their pwr* variants;
    reference: blocks/reduce.py:39-91; src/reduce.cu)."""

    batch_safe = True

    def __init__(self, axis, factor=None, op='sum'):
        self.specified_axis = axis
        self.specified_factor = factor
        self.op = op

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'f32'
        if itensor['dtype'] in ('cf32', 'cf64') and \
                not self.op.startswith('pwr'):
            otensor['dtype'] = 'cf32'
        if 'labels' in itensor and isinstance(self.specified_axis, str):
            self.axis = itensor['labels'].index(self.specified_axis)
        else:
            self.axis = self.specified_axis
        self.frame_axis = itensor['shape'].index(-1)
        self.factor = self.specified_factor
        if self.axis == self.frame_axis:
            if self.factor is None:
                raise ValueError(
                    "Reduce factor must be specified for frame axis")
            self.nframe_ratio = (1, self.factor)
        else:
            if self.factor is None:
                self.factor = otensor['shape'][self.axis]
            elif otensor['shape'][self.axis] % self.factor != 0:
                raise ValueError("Reduce factor does not divide axis length")
            otensor['shape'][self.axis] //= self.factor
        otensor['scales'][self.axis][1] *= self.factor
        self.otype = DataType(otensor['dtype'])
        return ohdr

    def build(self, in_meta):
        from .ops.reduce import _reduce_torch
        pre = _complexify_fn(in_meta)
        axis, factor, op = self.axis, self.factor, self.op
        tgt = self.otype.as_torch_dtype()

        def fn(x):
            y = _reduce_torch(pre(x), axis, factor, op)
            if y.is_complex() and not tgt.is_complex:
                y = y.real
            return y.to(tgt)
        return fn


class FftShiftStage(Stage):
    """Shift the zero-frequency element of each named axis to its center
    (reference: blocks/fftshift.py:37-81; ``bifrost_tpu/stages.py:
    341-378``), or back with ``inverse``."""

    batch_safe = True

    def __init__(self, axes, inverse=False):
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        self.specified_axes = axes
        self.inverse = inverse

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        self.axes = [_resolve_axis(itensor, ax)
                     for ax in self.specified_axes]
        if itensor['shape'].index(-1) in self.axes:
            raise KeyError("Cannot fftshift the frame axis")
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        if 'scales' in itensor:
            for ax in self.axes:
                sgn = +1 if self.inverse else -1
                step = otensor['scales'][ax][1]
                otensor['scales'][ax][0] += \
                    sgn * (otensor['shape'][ax] // 2) * step
        return ohdr

    def build(self, in_meta):
        import torch
        axes, inverse = list(self.axes), self.inverse
        shift = torch.fft.ifftshift if inverse else torch.fft.fftshift

        def fn(x):
            return shift(x, dim=axes)
        return fn


class ReverseStage(Stage):
    """Cyclic reversal b(i) = a(-i) of each named axis: element 0 stays
    and the rest reverse (reference: blocks/reverse.py:36-75;
    ``bifrost_tpu/stages.py:381-416``)."""

    batch_safe = True

    def __init__(self, axes):
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        self.specified_axes = axes

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        self.axes = [_resolve_axis(itensor, ax)
                     for ax in self.specified_axes]
        if itensor['shape'].index(-1) in self.axes:
            raise KeyError("Cannot reverse the frame axis")
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        if 'scales' in itensor:
            for ax in self.axes:
                step = otensor['scales'][ax][1]
                otensor['scales'][ax][0] += otensor['shape'][ax] * step
                otensor['scales'][ax][1] = -step
        return ohdr

    def build(self, in_meta):
        import torch
        axes = list(self.axes)

        def fn(x):
            for ax in axes:
                x = torch.roll(torch.flip(x, [ax]), 1, ax)
            return x
        return fn


class ScrunchStage(Stage):
    """Average every ``factor`` frames into one (reference:
    blocks/scrunch.py:38-66; ``bifrost_tpu/stages.py:451-480``); integer
    data are averaged in float32 and truncated back to their type."""

    batch_safe = True

    def __init__(self, factor):
        self.factor = factor
        self.nframe_ratio = (1, factor)

    def transform_header(self, hdr):
        ohdr = deepcopy(hdr)
        t = ohdr['_tensor']
        self.taxis = t['shape'].index(-1)
        t['scales'][self.taxis][1] *= self.factor
        return ohdr

    def build(self, in_meta):
        import torch
        f, taxis = self.factor, self.taxis

        def fn(x):
            nf = x.shape[taxis] // f
            y = x.reshape(x.shape[:taxis] + (nf, f) + x.shape[taxis + 1:])
            acc = y if (y.is_floating_point() or y.is_complex()) \
                else y.to(torch.float32)
            return acc.mean(dim=taxis + 1).to(x.dtype)
        return fn


class TransposeStage(Stage):
    """Axis permutation (reference: blocks/transpose.py:41-83): a
    ``permute`` and a contiguous copy, so the output gulp is laid out in
    the new axis order.  A complex-integer stream's trailing (re, im) axis
    stays last."""

    batch_safe = True

    def __init__(self, axes):
        self.specified_axes = axes

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        if 'labels' in itensor:
            self.axes = [_resolve_axis(itensor, ax)
                         for ax in self.specified_axes]
        else:
            self.axes = list(self.specified_axes)
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        for item in ('shape', 'labels', 'scales', 'units'):
            if item in itensor:
                otensor[item] = [itensor[item][ax] for ax in self.axes]
        return ohdr

    def build(self, in_meta):
        axes = list(self.axes)
        reim = in_meta.get('reim', False)

        def fn(x):
            a = axes + [len(axes)] if reim and x.dim() == len(axes) + 1 \
                else axes
            return x.permute(a).contiguous()
        return fn


class BeamformStage(Stage):
    """Coherent beamform: contract the station (and pol) axes of the
    voltage stream against a fixed weight set through the quantized
    beamformer engine (:class:`bifrost_tpu_torch.ops.beamform.Beamformer`:
    candidates gated and raced per the declared ``accuracy`` class;
    ``BF_BEAM_IMPL`` forces one).

    Input tensor: ``['time', 'freq', 'station']`` or ``['time', 'freq',
    'station', 'pol']``, dtype ci8 (the int8 planes feed the int8
    candidates directly) or complex float.  Weight shapes select the
    output form:

    - ``(B, S)`` on pol-less input, or ``(B, S*P)`` (pol folded into the
      contraction) -> ``['time', 'freq', 'beam']`` (modes 'nopol',
      'fold');
    - ``(B, S)`` / ``(P, B, S)`` with a pol axis -> per-pol beams,
      ``['time', 'freq', 'pol', 'beam']`` (mode 'perpol', the form the
      fused beamform -> Stokes -> integrate substitution recognizes,
      :func:`match_beamformer`).
    """

    batch_safe = True

    def __init__(self, weights, accuracy='f32', impl=None):
        from .ops.beamform import Beamformer
        self.engine = Beamformer(weights, accuracy=accuracy, impl=impl)
        self.accuracy = self.engine.accuracy

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        labels = itensor.get('labels')
        if not labels or labels[:2] != ['time', 'freq']:
            raise ValueError(
                "beamform requires ['time', 'freq', ...] input labels, "
                "got %r" % (labels,))
        itype = DataType(itensor['dtype'])
        if not itype.is_complex:
            raise TypeError('beamform requires complex voltages, got '
                            '%s' % itensor['dtype'])
        shape = itensor['shape']
        eng = self.engine
        if labels[2:] == ['station', 'pol']:
            s, p = shape[2], shape[3]
            if eng.npol_w == 1 and eng.nstand == s * p:
                self.mode = 'fold'
            elif eng.nstand == s and eng.npol_w in (1, p):
                self.mode = 'perpol'
            else:
                raise ValueError(
                    'weights (%d pol sets, %d inputs) match neither '
                    'per-pol station count %d nor folded %d'
                    % (eng.npol_w, eng.nstand, s, s * p))
            self.npol = p
        elif labels[2:] == ['station']:
            if eng.npol_w != 1 or eng.nstand != shape[2]:
                raise ValueError(
                    'weights expect %d inputs but the stream has %d '
                    'stations' % (eng.nstand, shape[2]))
            self.mode = 'nopol'
            self.npol = 1
        else:
            raise ValueError(
                "beamform requires trailing ['station'[, 'pol']] "
                "axes, got %r" % (labels[2:],))
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'cf32'
        for key, fill in (('shape', eng.nbeam), ('labels', 'beam'),
                          ('scales', [0, 1]), ('units', None)):
            if key not in otensor:
                continue
            vals = otensor[key]
            if self.mode == 'perpol':
                # ['time', 'freq', 'pol', 'beam']: the pol entry moves up
                vals = [deepcopy(vals[0]), deepcopy(vals[1]),
                        deepcopy(vals[3]), deepcopy(fill)]
            else:
                vals = [deepcopy(vals[0]), deepcopy(vals[1]),
                        deepcopy(fill)]
            otensor[key] = vals
        return ohdr

    def build(self, in_meta):
        reim = in_meta.get('reim', False)
        mode = self.mode
        engine = self.engine

        def fn(x):
            if reim and not x.is_complex():
                re, im = x[..., 0], x[..., 1]
            else:
                re, im = x.real, x.imag
            if mode == 'nopol':
                re, im = re[:, :, None, :], im[:, :, None, :]
            elif mode == 'fold':
                shp = (re.shape[0], re.shape[1], 1, -1)
                re, im = re.reshape(shp), im.reshape(shp)
            else:
                # (T, F, S, P) -> canonical (T, F, P, S), as a view
                re, im = re.transpose(2, 3), im.transpose(2, 3)
            y = engine(re, im)
            return y if mode == 'perpol' else y[:, :, 0, :]
        return fn



class QuantizeStage(Stage):
    """Requantize float data to a narrower (possibly complex-int) dtype
    inside a chain (the device math of
    :class:`bifrost_tpu_torch.blocks.quantize.QuantizeBlock` as a stage).
    In the FX correlator the channelizer's cf32 output requantizes to ci8
    between the F and X steps, so the X engine consumes int8 planes on
    its exact int32 path.  Rounds half to even, as the JAX stage does."""

    batch_safe = True

    def __init__(self, dtype, scale=1.):
        self.dtype = DataType(dtype)
        self.scale = scale

    def transform_header(self, hdr):
        ohdr = deepcopy(hdr)
        ohdr['_tensor']['dtype'] = str(self.dtype)
        return ohdr

    def build(self, in_meta):
        from .ops.quantize import quantize_tensor
        pre = _complexify_fn(in_meta)
        dt, scale = self.dtype, self.scale

        def fn(x):
            return quantize_tensor(pre(x), dt, scale)
        return fn


class CorrelateStage(Stage):
    """FX-correlator X step: one visibility matrix per ``nframe_per_vis``
    input frames, computed by the raced X engine
    (:class:`bifrost_tpu_torch.ops.linalg.XEngine`: candidates gated and
    raced per the declared ``accuracy`` class; ``BF_XCORR_IMPL`` forces
    one).

    Input tensor: ``['time', 'freq', 'station', 'pol']``, dtype ci8 (the
    int8 planes feed the exact int32 candidates) or complex float.
    Output: ``['time', 'freq', 'station_i', 'pol_i', 'station_j',
    'pol_j']`` cf32, the full visibility matrix (``matrix_fill_mode=
    'full'``), one output frame per integration.  Unlike the stateful
    :class:`bifrost_tpu_torch.blocks.correlate.CorrelateBlock`, the stage
    integrates whole groups within each gulp, so ``nframe_per_vis`` must
    divide the gulp.  The JAX stage's ``jax.vmap(engine)`` is a leading
    group axis here: the engine takes the gulp's (g, r, F, n) planes in
    one call, chosen by the per-group shape (r, F, n).
    """

    batch_safe = True

    def __init__(self, nframe_per_vis, accuracy='f32', impl=None):
        from .ops.linalg import XEngine
        self.nframe_per_vis = int(nframe_per_vis)
        if self.nframe_per_vis < 1:
            raise ValueError('nframe_per_vis must be >= 1')
        self.nframe_ratio = (1, self.nframe_per_vis)
        self.engine = XEngine(accuracy=accuracy, impl=impl)
        self.accuracy = self.engine.accuracy

    def transform_header(self, hdr):
        itensor = hdr['_tensor']
        labels = itensor.get('labels')
        if labels != ['time', 'freq', 'station', 'pol']:
            raise ValueError(
                "correlate requires ['time', 'freq', 'station', "
                "'pol'] input labels, got %r" % (labels,))
        itype = DataType(itensor['dtype'])
        if not itype.is_complex:
            raise TypeError('correlate requires complex voltages, '
                            'got %s' % itensor['dtype'])
        ohdr = deepcopy(hdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'cf32'
        for key in ('shape', 'labels', 'scales', 'units'):
            if key not in itensor:
                continue
            tv, fv, sv, pv = (deepcopy(v) for v in itensor[key])
            otensor[key] = [tv, fv, sv, pv,
                            deepcopy(sv) if key != 'labels'
                            else sv + '_j',
                            deepcopy(pv) if key != 'labels'
                            else pv + '_j']
        if 'labels' in otensor:
            otensor['labels'][2] += '_i'
            otensor['labels'][3] += '_i'
        if 'scales' in otensor:
            otensor['scales'][0][1] *= self.nframe_per_vis
        ohdr['matrix_fill_mode'] = 'full'
        return ohdr

    def build(self, in_meta):
        import torch
        reim = in_meta.get('reim', False)
        r = self.nframe_per_vis
        t = in_meta['shape'][0]
        if t % r:
            raise ValueError(
                'CorrelateStage: gulp nframe %d not divisible by '
                'nframe_per_vis %d' % (t, r))
        engine = self.engine

        def fn(x):
            if reim and not x.is_complex():
                re, im = x[..., 0], x[..., 1]
            else:
                re, im = x.real, x.imag
            nt, f, s, p = re.shape
            # views of the gulp: (g, r, F, S*P) strided planes
            re = re.reshape(nt // r, r, f, s * p)
            im = im.reshape(nt // r, r, f, s * p)
            vis = engine(re, im)                    # (g, f, n, n)
            return vis.reshape(nt // r, f, s, p, s, p) \
                .to(torch.complex64)
        return fn


class AccumulateStage(ReduceStage):
    """Frame-axis integration inside a chain, the stateless twin of
    :class:`bifrost_tpu_torch.blocks.accumulate.AccumulateBlock`: sums
    whole groups of ``nframe`` frames within a gulp.  The FX chain uses
    it to integrate visibility matrices after the X step."""

    def __init__(self, nframe, op='sum'):
        super(AccumulateStage, self).__init__('time', factor=int(nframe),
                                              op=op)


class MapStage(Stage):
    """User-defined elementwise stage: a bf.map expression reading 'a'
    (the input) and writing 'b' (the output), evaluated with torch ops on
    the input's device (``bifrost_tpu/stages.py:747-788``).  ``dtype``
    sets the output type (the input's by default); ``scalars`` names
    constants the expression reads.  Composes with its neighbours in
    :func:`compose_stages` and ``fused(...)``."""

    batch_safe = True

    def __init__(self, func_string, dtype=None, scalars=None):
        self.func_string = func_string
        self.dtype = dtype
        self.scalars = dict(scalars or {})

    def transform_header(self, hdr):
        ohdr = deepcopy(hdr)
        if self.dtype is not None:
            ohdr['_tensor']['dtype'] = str(DataType(self.dtype))
        self.otype = DataType(ohdr['_tensor']['dtype'])
        return ohdr

    def build(self, in_meta):
        from .ops.map import _Eval, _logical_dtype, _to_device_rep, _Unsigned
        from .ops.map_lang import compile_map
        pre = _complexify_fn(in_meta)
        body = compile_map(self.func_string, ['a', 'b'] +
                           list(self.scalars))
        otype = self.otype
        idt = in_meta['dtype']
        # a_type is the input's logical type after complexification
        atype = idt.as_floating_point() if idt.kind == 'ci' else idt
        scalars = dict(self.scalars)
        lshape = tuple(in_meta['shape'][:len(in_meta['shape']) -
                                        (1 if in_meta.get('reim') else 0)])
        ldt = _logical_dtype(otype)
        unsigned = {'b': ldt} if isinstance(ldt, _Unsigned) else {}

        def fn(x):
            import torch
            x = pre(x)
            ev = _Eval(lshape, None, {'a': x}, scalars,
                       {'a': atype, 'b': otype}, {}, device=x.device,
                       unsigned=unsigned)
            ev.out = {'b': torch.zeros(
                x.shape, dtype=torch.int64 if unsigned else ldt,
                device=x.device)}
            ev.writable.add('b')
            ev.run(body)
            return _to_device_rep(ev.out['b'], otype).to(
                otype.as_torch_dtype())
        return fn


def chain_overlap_nframe(stages):
    """Input-frame lookahead a stage chain needs, or None.

    Walks the chain back from the sink, converting each downstream halo
    through the stage's frame ratio and adding the stage's own
    ``overlap_nframe``.  Returns None when a downstream halo does not
    convert to a whole input-frame count.  The port keeps it, as it keeps
    ``batch_safe``, for its segment slice, which reads it."""
    halo = 0
    for stage in reversed(stages):
        num, den = getattr(stage, 'nframe_ratio', (1, 1))
        if halo:
            if (halo * den) % num:
                return None
            halo = halo * den // num
        halo += int(getattr(stage, 'overlap_nframe', 0) or 0)
    return halo


class FdmtStage(Stage):
    """Incoherent dedispersion (FDMT) as a stage: the core of
    :class:`bifrost_tpu_torch.blocks.fdmt.FdmtBlock` with a static
    ``max_delay``, so the lookahead (``overlap_nframe``) is known before
    any header flows.

    Input tensor ``[..., 'freq', 'time']`` (time is the frame axis and
    rides last); the output replaces the freq axis with ``max_delay``
    dispersion trials.  Output frame t is a fixed-order sum over input
    frames [t, t + max_delay] (positive delays only, the lookahead the
    ring overlap implements), so committed frames are the same whatever
    span computed them.  The per-gulp core is the raced engine
    (:class:`bifrost_tpu_torch.ops.fdmt.Fdmt`; ``BF_FDMT_IMPL`` forces
    one); it is chosen when the stage builds for the first gulp shape.
    The JAX stage's ``jax.vmap`` over leading axes is the engine's batch
    axis here.
    """

    batch_safe = True

    def __init__(self, max_delay, exponent=-2.0):
        from .ops.fdmt import Fdmt
        self.max_delay = int(max_delay)
        if self.max_delay < 1:
            raise ValueError('max_delay must be >= 1')
        self.exponent = exponent
        self.overlap_nframe = self.max_delay
        self.engine = Fdmt()

    def transform_header(self, hdr):
        from .ops.fdmt import KDM
        itensor = hdr['_tensor']
        labels = itensor.get('labels')
        if not labels or labels[-1] != 'time' or labels[-2] != 'freq':
            raise KeyError("fdmt requires [..., 'freq', 'time'] input "
                           "labels, got %r" % (labels,))
        nchan = itensor['shape'][-2]
        f0_, df_ = itensor['scales'][-2]
        dt_ = itensor['scales'][-1][1]
        units = itensor.get('units')
        funit = units[-2] if units else 'MHz'
        tunit = units[-1] if units else 's'
        f0 = convert_units(f0_, funit, 'MHz')
        df = convert_units(df_, funit, 'MHz')
        dt = convert_units(dt_, tunit, 's')
        fac = f0 ** -2 - (f0 + nchan * df) ** -2
        max_dm = self.max_delay * dt / (KDM * abs(fac))
        self.dm_step = max_dm / self.max_delay
        self.engine.init(nchan, self.max_delay, f0, df, self.exponent,
                         space='cuda')
        ohdr = deepcopy(hdr)
        refdm = convert_units(hdr['refdm'], hdr['refdm_units'],
                              'pc cm^-3') if 'refdm' in hdr else 0.
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'f32'
        otensor['shape'][-2] = self.max_delay
        otensor['labels'][-2] = 'dispersion'
        if 'scales' in otensor:
            otensor['scales'][-2] = [refdm, self.dm_step]
        if units:
            otensor['units'][-2] = 'pc cm^-3'
        ohdr['max_dm'] = max_dm
        ohdr['max_dm_units'] = 'pc cm^-3'
        ohdr['cfreq'] = f0_ + 0.5 * (nchan - 1) * df_
        ohdr['cfreq_units'] = funit
        ohdr['bw'] = nchan * df_
        ohdr['bw_units'] = funit
        return ohdr

    def build(self, in_meta):
        shape = in_meta['shape']
        # probe and lock the core at the actual (nchan, T) of this gulp
        return self.engine._gulp_fn(self.engine._pick_core(
            False, shape=(int(shape[-2]), int(shape[-1]))))


class MatchedFilterStage(Stage):
    """Boxcar matched filter along the frame (time) axis: output frame t =
    sum of input frames [t, t + ntap - 1], summed in a fixed order (ntap
    shifted adds, never a cumsum difference, whose cancellation would make
    a frame depend on the span it was computed in).  Declares ``ntap - 1``
    frames of lookahead."""

    batch_safe = True

    def __init__(self, ntap):
        self.ntap = int(ntap)
        if self.ntap < 1:
            raise ValueError('ntap must be >= 1')
        self.overlap_nframe = self.ntap - 1

    def transform_header(self, hdr):
        ohdr = deepcopy(hdr)
        t = ohdr['_tensor']
        self.taxis = t['shape'].index(-1)
        self.otype = DataType(t['dtype']).as_floating_point()
        if self.otype.is_complex:
            raise TypeError('matched filter requires real input, got '
                            '%s' % t['dtype'])
        t['dtype'] = str(self.otype)
        return ohdr

    def build(self, in_meta):
        W, taxis = self.ntap, self.taxis
        odt = self.otype.as_torch_dtype()

        def fn(x):
            import torch
            x = x.to(odt)
            if W == 1:
                return x
            T = x.shape[taxis]
            pad = list(x.shape)
            pad[taxis] = W - 1
            xp = torch.cat([x, x.new_zeros(pad)], dim=taxis)
            y = xp.narrow(taxis, 0, T)
            for i in range(1, W):
                y = y + xp.narrow(taxis, i, T)
            return y
        return fn


class ThresholdStage(Stage):
    """Peak detect: zero every sample below ``threshold`` (elementwise and
    frame-local).  The candidate sink counts the surviving nonzero
    samples; the zeroed shape keeps the chain static-shaped."""

    batch_safe = True

    def __init__(self, threshold):
        self.threshold = float(threshold)

    def transform_header(self, hdr):
        return deepcopy(hdr)

    def build(self, in_meta):
        thr = self.threshold

        def fn(x):
            import torch
            return torch.where(x >= thr, x, x.new_zeros(()))
        return fn


def walk_headers(stages, hdr):
    """Run ``hdr`` through every stage's transform_header; returns the
    header list (input + one per stage output)."""
    headers = [hdr]
    for stage in stages:
        hdr = stage.transform_header(hdr)
        headers.append(hdr)
    return headers


def _device_shape(hdr, nframe):
    t = hdr['_tensor']
    shape = [nframe if s == -1 else s for s in t['shape']]
    return shape + ([2] if DataType(t['dtype']).kind == 'ci' else [])


def compose_stages(stages, headers, shape, dtype, substitute=True):
    """The one-gulp function of a stage chain: FusedBlock runs exactly
    this per gulp.  ``shape`` and ``dtype`` describe the device-rep input
    tensor.

    Returns ``(fn, info)``: ``info`` records the path ``fn`` runs,
    ``{'impl': 'cuda-spectrometer', ...}`` or ``{'impl':
    'cuda-beamform-detect', ...}`` when a whole-chain kernel is
    substituted (``substitute`` True and :func:`match_spectrometer` or
    :func:`match_beamformer` matches), else ``{'impl': 'torch-fused'}``.  ``substitute=False`` is
    the only way to keep the per-stage path on a matching chain."""
    if substitute:
        plan = match_spectrometer(stages, headers, shape, dtype)
        if plan is None:
            plan = match_beamformer(stages, headers, shape, dtype)
        if plan is not None:
            return plan, plan.info
    taxis = headers[0]['_tensor']['shape'].index(-1)
    nframe = int(shape[taxis])
    fns = []
    cur = list(shape)
    for stage, ihdr, ohdr in zip(stages, headers[:-1], headers[1:]):
        idt = DataType(ihdr['_tensor']['dtype'])
        fns.append(stage.build({'shape': cur, 'dtype': idt,
                                'reim': idt.kind == 'ci'}))
        nframe = stage.output_nframe(nframe)
        cur = _device_shape(ohdr, nframe)

    def composed(x):
        return _reduce(lambda v, f: f(v), fns, x)
    return composed, {'impl': 'torch-fused'}


class SpectrometerPlan(object):
    """Callable wrapper around the substituted whole-chain kernel that
    records its configuration, so the block that runs it can publish
    what ran (FusedBlock.impl_info)."""

    def __init__(self, fn, info):
        self.fn = fn
        self.info = dict(info)

    def __call__(self, x):
        return self.fn(x)


def _is_int8(dtype):
    return str(dtype) in ('int8', 'torch.int8')


def match_spectrometer(stages, headers, shape, dtype):
    """Recognize the Guppi spectrometer pattern, FftStage (c2c forward,
    no shift, last axis) -> DetectStage('stokes', pol axis 1) ->
    ReduceStage(axis 2, r, 'sum') on ci8 dual-pol input, and return K1
    (:func:`bifrost_tpu_torch.ops.spectrometer.fused_spectrometer`) as a
    :class:`SpectrometerPlan`; else None.  Unlike the JAX package, the
    substitution is not gated on a runtime accuracy probe: the kernel's
    gate is checked on the card by ``chip_smoke.py``."""
    if len(stages) != 3:
        return None
    f, d, r = stages
    if not (isinstance(f, FftStage) and isinstance(d, DetectStage)
            and isinstance(r, ReduceStage)):
        return None
    if headers[0]['_tensor']['dtype'] != 'ci8':
        return None
    if not _is_int8(dtype) or len(shape) != 4:
        return None
    from .ops import spectrometer as spec
    ntime, npol, nfft, two = shape
    if npol != 2 or two != 2 or nfft < 4 or (nfft & (nfft - 1)) or \
            nfft > spec.MAX_NFFT:
        return None
    if f.mode != 'c2c' or f.inverse or f.apply_fftshift or f.axes != [2]:
        return None
    if d.mode != 'stokes' or d.axis_index != 1 or d.npol != 2:
        return None
    if r.op != 'sum' or r.axis != 2 or not r.factor or nfft % r.factor:
        return None
    from .device import get_device
    factor = r.factor

    def fn(x):
        return spec.fused_spectrometer(x, rfactor=factor)
    return SpectrometerPlan(fn, {
        'impl': 'cuda-spectrometer',
        'kernel': 'cuda' if get_device().type == 'cuda' else 'plain',
        'nfft': nfft,
        'rfactor': factor,
    })


def match_beamformer(stages, headers, shape, dtype):
    """Recognize the quantized beamform-and-detect pattern, BeamformStage
    (per pol, dual pol) -> DetectStage('stokes', pol axis 2) ->
    ReduceStage('sum') over the frame axis on ci8 input, and return K6
    (:func:`bifrost_tpu_torch.ops.beamform.fused_detect`) as a plan; else
    None.

    ``BF_BEAM_FUSED`` (:func:`~bifrost_tpu_torch.ops.beamform.fused_mode`):
    'off' never substitutes; 'auto' substitutes when the engine's
    accuracy class admits int8 (the kernel's weights are quantized by
    construction) or ``impl='pallas'`` was forced; 'force' substitutes
    whenever the chain matches.  As for the spectrometer, the match is
    not gated on the device (on a CPU tensor the wrapper runs K6's plain
    version) nor on a runtime compile probe: the shape conditions the
    kernel needs are checked here, and its wrapper raises on what it does
    not take."""
    if len(stages) != 3:
        return None
    b, d, r = stages
    if not (isinstance(b, BeamformStage) and isinstance(d, DetectStage)
            and isinstance(r, ReduceStage)):
        return None
    if headers[0]['_tensor']['dtype'] != 'ci8':
        return None
    if not _is_int8(dtype) or len(shape) != 5:
        return None
    ntime, nfreq, nstand, npol, two = shape
    if npol != 2 or two != 2:
        return None
    if getattr(b, 'mode', None) != 'perpol':
        return None
    if d.mode != 'stokes' or d.axis_index != 2 or d.npol != 2:
        return None
    if r.op != 'sum' or r.axis != r.frame_axis or not r.factor:
        return None
    from .ops import beamform as _beam
    from .ops.gpu_kernels import MAX_NSTAND
    if ntime % r.factor or nstand > MAX_NSTAND:
        return None
    mode = _beam.fused_mode()
    if mode == 'off':
        return None
    eng = b.engine
    if mode != 'force' and eng._force != 'pallas' and \
            _beam.beam_class_rtol(eng.accuracy) < _beam.BEAM_CLASSES['int8']:
        return None
    from .device import get_device
    factor = r.factor

    def fn(x):
        return _beam.fused_detect(eng, x, factor)
    return SpectrometerPlan(fn, {
        'impl': 'cuda-beamform-detect',
        'kernel': 'cuda' if get_device().type == 'cuda' else 'plain',
        'rfactor': factor,
        'nbeam': eng.nbeam,
        'accuracy': eng.accuracy,
        'wscale': float(eng.wscale),
    })
