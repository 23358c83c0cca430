"""bf.map: user-defined array transformations (the port of
``bifrost_tpu/ops/map.py``; reference: python/bifrost/map.py:58-143,
src/map.cpp:630-797).

``map(func_string, data, ...)`` evaluates a C-like elementwise or
ND-indexed expression over arrays (see :mod:`.map_lang` for the
language).  The reference generates CUDA C at run time with NVRTC; the
JAX package evaluates the AST with jax.numpy under ``jax.jit``.  The port
evaluates the same AST eagerly with torch ops on the device that
:func:`bifrost_tpu_torch.device.get_device` names, so each statement runs
as torch's own kernels on the card.  Parsed expressions are memoized in
an :class:`~bifrost_tpu_torch.utils.ObjectCache` under the expression and
the names it is given, the analogue of the reference's kernel cache
(src/map.cpp:676-701); :func:`list_map_cache` lists the keys the JAX
package caches its executors under (function string, the arrays' names,
shapes, dtypes and vector lengths, the scalars' names, the axis names and
the iteration shape).

Semantics, as in the JAX package:

- integer '/' and '%' truncate toward zero (C);
- a negative index counts from the end of its axis (``a(_-n/2)`` is
  fftshift); an index still out of range clamps to the axis in a gather
  and drops the element in a store, as jnp's gather and scatter do (C
  leaves both undefined);
- ``if``/``else`` run SIMT style: both branches run and their stores
  merge under the condition mask;
- an indexed store writes the output out of place (a copy on its first
  store) unless the output is the caller's own tensor, which it updates
  in place; no input that is not an output is ever written;
- Python scalars do not widen a tensor's type (``int8 + 1`` stays int8),
  as jnp's weak types do not.

Where the port differs on purpose:

- ``double`` computes in float64 (and ``Complex<double>`` in
  complex128), as the C source says; the JAX package runs without x64
  and computes float32;
- unsigned 16- and 32-bit values compute in int64 (torch has few
  ``uint32`` ops on CUDA) and wrap to their width where they are cast to
  ``unsigned`` or stored.
"""

from __future__ import annotations

import math

import numpy as np

from ..dtype import DataType
from ..utils import ObjectCache
from .common import from_logical_numpy, to_logical_numpy
from .map_lang import (compile_map, MapSyntaxError, Num, Name, BinOp, UnOp,
                       Ternary, CallIndex, Subscript, Method, Attr, Cast,
                       Ctor, Decl, Assign, AssignCall, If)

__all__ = ['map', 'map_compute', 'clear_map_cache', 'list_map_cache',
           'MapSyntaxError']

#: host storage <-> logical values, shared with ops.quantize
_to_logical = to_logical_numpy
_from_logical = from_logical_numpy

# Parsed expressions (body, outputs), keyed on the expression, the names
# it is given and which of them are arrays, so that a call parses only on
# a miss: the analogue of the reference's in-memory kernel cache
# (ObjectCache, src/map.cpp:642).
_parsed = ObjectCache(capacity=256)
# The keys the JAX package caches its executors under, one for each
# expression, shapes, dtypes, scalars, axes and iteration shape run.
_keys = ObjectCache(capacity=256)


def clear_map_cache():
    _parsed.clear()
    _keys.clear()


def list_map_cache():
    """Keys of cached map expressions, as the JAX package lists them
    (reference: bfMapQuery / list_map_cache, python/bifrost/map.py)."""
    return list(_keys.keys())


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class IndexVec(object):
    """The implicit index vector ``_`` (or a transformed version): one
    integer component per iteration axis, supporting per-axis arithmetic."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    def binop(self, op, other, reverse=False):
        if isinstance(other, IndexVec):
            oparts = other.parts
        elif isinstance(other, ShapeVec):
            oparts = other.dims
        else:
            oparts = (other,) * len(self.parts)
        if len(oparts) != len(self.parts):
            raise ValueError("Index-vector length mismatch")
        if reverse:
            return IndexVec([op(b, a) for a, b in zip(self.parts, oparts)])
        return IndexVec([op(a, b) for a, b in zip(self.parts, oparts)])


class ShapeVec(object):
    """Result of ``a.shape()``: a tuple of ints with per-axis arithmetic."""

    def __init__(self, dims):
        self.dims = tuple(dims)

    def binop(self, op, other, reverse=False):
        if isinstance(other, (ShapeVec, IndexVec)):
            oparts = other.dims if isinstance(other, ShapeVec) \
                else other.parts
        else:
            oparts = (other,) * len(self.dims)
        if reverse:
            return ShapeVec([op(b, a) for a, b in zip(self.dims, oparts)])
        return ShapeVec([op(a, b) for a, b in zip(self.dims, oparts)])


class Vec(object):
    """A small fixed-length vector value (reference: Vector.hpp): a
    tensor whose trailing axis is the component axis."""

    def __init__(self, arr):
        self.arr = arr


class ArrayRef(object):
    """A named data array, before we know whether it's used elementwise or
    explicitly indexed."""

    def __init__(self, name, arr, veclen=1):
        self.name = name
        self.arr = arr         # tensor (logical values; vec axis last)
        self.veclen = veclen

    @property
    def index_ndim(self):
        return self.arr.dim() - (1 if self.veclen > 1 else 0)


class _Unsigned(object):
    """An unsigned type of ``nbits`` (16 or 32) computed in int64 and
    wrapped to its width where it is cast or stored."""

    def __init__(self, nbits):
        self.nbits = nbits
        self.mask = (1 << nbits) - 1


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

def _torch_dtype(np_dtype):
    """The torch dtype (or :class:`_Unsigned`) a C type computes in."""
    import torch
    np_dtype = np.dtype(np_dtype)
    if np_dtype in (np.uint16, np.uint32):
        return _Unsigned(8 * np_dtype.itemsize)
    return {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
            np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
            np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
            np.dtype(np.uint64): torch.int64,
            np.dtype(np.float16): torch.float16,
            np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64,
            np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}[np_dtype]


def _logical_dtype(dt):
    """The compute dtype of a DataType's logical values: complex integers
    as complex64, packed integers as int8/uint8, cf16 as complex64."""
    import torch
    if dt.kind == 'ci':
        return torch.complex64
    if dt.kind == 'cf':
        return torch.complex128 if dt.nbits > 32 else torch.complex64
    if dt.kind == 'u' and dt.nbits in (16, 32):
        return _Unsigned(dt.nbits)
    if dt.kind == 'u' and dt.nbits == 64:
        return torch.int64
    return dt.as_torch_dtype()


def _dtype_name(dtype):
    """numpy's name of a torch dtype ('int32', 'complex64', 'bool')."""
    return str(dtype).replace('torch.', '')


_TYPE_MAP = {
    'int': np.int32, 'long': np.int64, 'short': np.int16,
    'char': np.int8, 'signed char': np.int8, 'unsigned char': np.uint8,
    'unsigned': np.uint32, 'unsigned int': np.uint32,
    'float': np.float32, 'double': np.float64, 'bool': np.bool_,
}


# ---------------------------------------------------------------------------
# scalar / tensor helpers
# ---------------------------------------------------------------------------

def _is_tensor(x):
    import torch
    return isinstance(x, torch.Tensor)


def _is_int(x):
    if _is_tensor(x):
        return not (x.is_floating_point() or x.is_complex()) and \
            str(x.dtype) != 'torch.bool'
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _cdiv(a, b):
    """C-style integer division (truncation toward zero)."""
    import torch
    if not _is_tensor(a) and not _is_tensor(b):
        q = abs(int(a)) // abs(int(b))
        return q if (a < 0) == (b < 0) else -q
    if not _is_tensor(a):
        a = torch.as_tensor(a, dtype=torch.result_type(b, a),
                            device=b.device)
    return torch.div(a, b, rounding_mode='trunc')


def _cmod(a, b):
    import torch
    if not _is_tensor(a) and not _is_tensor(b):
        return int(a) - _cdiv(a, b) * int(b)
    if not _is_tensor(a):
        a = torch.as_tensor(a, dtype=torch.result_type(b, a),
                            device=b.device)
    return torch.fmod(a, b)


def _real(x):
    if _is_tensor(x):
        return x.real if x.is_complex() else x
    return x.real if isinstance(x, complex) else x


def _imag(x):
    import torch
    if _is_tensor(x):
        return x.imag if x.is_complex() else torch.zeros_like(x)
    return x.imag if isinstance(x, complex) else 0


class _Eval(object):
    def __init__(self, shape, axis_names, arrays, scalars, dtypes, veclens,
                 device=None, unsigned=None):
        import torch
        from ..device import get_device
        self.torch = torch
        self.device = get_device() if device is None else device
        self.shape = tuple(shape)
        self.axis_names = list(axis_names or [])
        self.arrays = arrays          # name -> tensor (logical)
        self.scalars = scalars        # name -> Python scalar
        self.dtypes = dtypes          # name -> DataType (logical)
        self.veclens = veclens
        self.unsigned = dict(unsigned or {})  # name -> _Unsigned
        self.env = {}
        self.out = {}                 # name -> current output tensor
        self.writable = set()         # outputs that may be written in place
        self.mask = None              # active SIMT mask

    # -- helpers ----------------------------------------------------------
    def tensor(self, x, dtype=None):
        """``x`` as a tensor on the evaluation device."""
        torch = self.torch
        if _is_tensor(x):
            return x if dtype is None else x.to(dtype)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def pair(self, a, b):
        """``a`` and ``b`` as tensors; a Python scalar takes the type
        promotion gives it beside the other operand."""
        torch = self.torch
        if _is_tensor(a) and _is_tensor(b):
            return a, b
        if _is_tensor(a):
            return a, self.tensor(b, torch.result_type(a, b))
        if _is_tensor(b):
            return self.tensor(a, torch.result_type(b, a)), b
        return self.tensor(a), self.tensor(b)

    def where(self, cond, new, old):
        return self.torch.where(self.tensor(cond).to(self.torch.bool),
                                new, old)

    def iota(self, axis):
        torch = self.torch
        n = len(self.shape)
        return torch.arange(self.shape[axis], dtype=torch.int32,
                            device=self.device).reshape(
            [self.shape[axis] if k == axis else 1 for k in range(n)])

    def index_vec(self):
        return IndexVec([self.iota(k) for k in range(len(self.shape))])

    def value(self, v):
        """Collapse ArrayRef used elementwise / 1-length vectors."""
        if isinstance(v, ArrayRef):
            if v.veclen > 1:
                return Vec(v.arr)
            return v.arr
        if isinstance(v, (IndexVec, ShapeVec)):
            parts = v.parts if isinstance(v, IndexVec) else v.dims
            if len(parts) == 1:
                return parts[0]
            raise ValueError("Index vector used as scalar")
        return v

    def resolve_dtype(self, tname):
        """The torch dtype (or :class:`_Unsigned`) of a type name."""
        torch = self.torch
        tname = tname.strip()
        if tname == 'auto':
            return None
        if tname.startswith('Complex'):
            inner = tname[len('Complex'):].strip('<> ')
            base = self.resolve_dtype(inner) if inner else torch.float32
            return torch.complex128 if base == torch.float64 \
                else torch.complex64
        if '::' in tname:
            base, _, member = tname.partition('::')
            return self.resolve_dtype(base)  # value_type = element type
        if tname.endswith('_type'):
            name = tname[:-len('_type')]
            if name in self.dtypes:
                return _logical_dtype(self.dtypes[name])
            raise MapSyntaxError("Unknown type %r" % tname)
        if tname in _TYPE_MAP:
            return _torch_dtype(_TYPE_MAP[tname])
        raise MapSyntaxError("Unknown type %r" % tname)

    def astype(self, val, dt):
        """C conversion of a value to torch dtype or :class:`_Unsigned`
        ``dt`` (floats truncate toward zero into integers; complex drops
        its imaginary part into a real type)."""
        torch = self.torch
        v = self.tensor(val)
        target_complex = not isinstance(dt, _Unsigned) and dt.is_complex
        if v.is_complex() and not target_complex:
            v = v.real
        if isinstance(dt, _Unsigned):
            if v.is_floating_point():
                v = torch.trunc(v)
            return v.to(torch.int64) & dt.mask
        if not (dt.is_floating_point or dt.is_complex) and \
                v.is_floating_point():
            v = torch.trunc(v)
        return v.to(dt)

    def cast(self, val, tname):
        dt = self.resolve_dtype(tname)
        if dt is None:
            return val
        if isinstance(val, Vec):
            return Vec(self.astype(val.arr, dt))
        return self.astype(self.value(val), dt)

    def masked(self, new, old):
        if self.mask is None:
            return new
        if isinstance(new, Vec):
            oldarr = old.arr if isinstance(old, Vec) else old
            return Vec(self.where(self.mask[..., None], new.arr, oldarr))
        if old is None:
            return new
        return self.where(self.mask, self.tensor(new), old)

    # -- name resolution ---------------------------------------------------
    def lookup(self, name):
        if name == '_':
            return self.index_vec()
        if name in self.env:
            return self.env[name]
        if name in self.axis_names:
            return self.iota(self.axis_names.index(name))
        if name in self.out:
            return ArrayRef(name, self.out[name],
                            self.veclens.get(name, 1))
        if name in self.arrays:
            return ArrayRef(name, self.arrays[name],
                            self.veclens.get(name, 1))
        if name in self.scalars:
            return self.scalars[name]
        raise MapSyntaxError("Unknown name %r" % name)

    # -- gather / scatter ---------------------------------------------------
    def build_index(self, ref, args):
        """Evaluate index args into a tuple of int64 index tensors for
        ``ref``, a negative index counted from the end of its axis (as
        jnp does); an index that stays out of range is left so."""
        torch = self.torch
        parts = []
        for a in args:
            v = self.eval(a)
            if isinstance(v, IndexVec):
                parts.extend(v.parts)
            elif isinstance(v, ShapeVec):
                parts.extend(v.dims)
            elif isinstance(v, ArrayRef):
                parts.append(v.arr)
            else:
                parts.append(v)
        if len(parts) != ref.index_ndim:
            raise MapSyntaxError(
                "Array %r indexed with %d indices; has %d axes"
                % (ref.name, len(parts), ref.index_ndim))
        idx = []
        for p, n in zip(parts, ref.arr.shape):
            if _is_tensor(p):
                p = p.to(torch.int64)
                idx.append(torch.where(p < 0, p + n, p))
            else:
                p = int(p)
                idx.append(torch.tensor(p + n if p < 0 else p,
                                        device=self.device))
        return tuple(idx)

    @staticmethod
    def clamped(idx, shape):
        """``idx`` with each index clamped to its axis, as jnp's gather
        takes an index out of range."""
        return tuple(i.clamp(0, n - 1) for i, n in zip(idx, shape))

    def gather(self, ref, args):
        res = ref.arr[self.clamped(self.build_index(ref, args),
                                   ref.arr.shape)]
        if ref.veclen > 1:
            return Vec(res)
        return res

    # -- expression evaluation ----------------------------------------------
    def eval(self, node):
        torch = self.torch
        if isinstance(node, Num):
            return float(node.value) if node.is_float else node.value
        if isinstance(node, Name):
            return self.lookup(node.id)
        if isinstance(node, BinOp):
            return self.binop(node.op, node.left, node.right)
        if isinstance(node, UnOp):
            v = self.eval(node.operand)
            if node.op == '-':
                if isinstance(v, (IndexVec, ShapeVec)):
                    return v.binop(lambda a, b: -a, 0)
                if isinstance(v, Vec):
                    return Vec(-v.arr)
                return -self.value(v)
            if node.op == '+':
                return v
            if node.op == '!':
                return torch.logical_not(self.tensor(self.value(v)))
            if node.op == '~':
                return ~self.value(v)
        if isinstance(node, Ternary):
            c = self.value(self.eval(node.cond))
            t = self.eval(node.then)
            o = self.eval(node.other)
            if isinstance(t, Vec) or isinstance(o, Vec):
                ta = t.arr if isinstance(t, Vec) else t
                oa = o.arr if isinstance(o, Vec) else o
                return Vec(self.where(self.tensor(c)[..., None], ta, oa))
            tv, ov = self.value(t), self.value(o)
            if not _is_tensor(tv) and not _is_tensor(ov):
                tv, ov = self.pair(tv, ov)
            return self.where(c, tv, ov)
        if isinstance(node, CallIndex):
            base = node.base.id
            # math function or cast-call?
            if base in _TYPE_MAP or base == 'Complex':
                args = [self.value(self.eval(a)) for a in node.args]
                if base == 'Complex':
                    return self.make_complex(torch.complex64, args)
                return self.cast(args[0], base)
            if base in _FUNCS:
                args = [self.value(self.eval(a)) for a in node.args]
                return _FUNCS[base](self, *args)
            ref = self.lookup(base)
            if isinstance(ref, ArrayRef):
                return self.gather(ref, node.args)
            raise MapSyntaxError("Cannot call %r" % base)
        if isinstance(node, Subscript):
            v = self.eval(node.base)
            i = self.value(self.eval(node.index))
            if isinstance(v, Vec):
                return v.arr[..., i]
            if isinstance(v, ArrayRef):
                return v.arr[i]
            return v[..., i]
        if isinstance(node, Method):
            return self.method(node)
        if isinstance(node, Attr):
            v = self.eval(node.base)
            if node.name == 'real':
                return _real(self.value(v))
            if node.name == 'imag':
                return _imag(self.value(v))
            raise MapSyntaxError("Unknown attribute .%s" % node.name)
        if isinstance(node, Cast):
            return self.cast(self.eval(node.operand), node.type_name)
        if isinstance(node, Ctor):
            return self.ctor(node)
        raise MapSyntaxError("Cannot evaluate %r" % node)

    def make_complex(self, dt, args):
        torch = self.torch
        if len(args) == 1:
            return self.tensor(args[0]).to(dt)
        fdt = torch.float64 if dt == torch.complex128 else torch.float32
        re, im = (self.tensor(_real(a)).to(fdt) for a in args)
        return torch.complex(*torch.broadcast_tensors(re, im))

    def ctor(self, node):
        torch = self.torch
        tname = node.type_name
        args = [self.eval(a) for a in node.args]
        if tname.startswith('Complex') or '::' in tname:
            dt = self.resolve_dtype(tname) or torch.complex64
            if isinstance(dt, _Unsigned) or not dt.is_complex:
                dt = torch.complex64
            return self.make_complex(dt, [self.value(a) for a in args])
        # vector construction: T(a, b, c, d)
        vals = [self.value(a) for a in args]
        if len(vals) == 1:
            return self.cast(vals[0], tname)
        vals = [self.tensor(v) for v in vals]
        dt = vals[0].dtype
        for v in vals[1:]:
            dt = torch.promote_types(dt, v.dtype)
        vals = torch.broadcast_tensors(*[v.to(dt) for v in vals])
        return Vec(torch.stack(vals, dim=-1))

    def method(self, node):
        torch = self.torch
        name = node.name
        base = self.eval(node.base)
        if name == 'shape':
            if isinstance(base, ArrayRef):
                shp = tuple(base.arr.shape)
                if base.veclen > 1:
                    shp = shp[:-1]
            else:
                shp = tuple(self.tensor(self.value(base)).shape)
            if node.args:
                ax = self.value(self.eval(node.args[0]))
                return shp[int(ax)]
            return ShapeVec(shp)
        v = self.value(base)
        if name == 'conj':
            if isinstance(v, Vec):
                return Vec(torch.conj_physical(v.arr))
            return torch.conj_physical(self.tensor(v))
        if name in ('mag2', 'norm'):
            v = self.tensor(v)
            return _real(v) ** 2 + _imag(v) ** 2
        if name in ('mag', 'abs'):
            return torch.abs(self.tensor(v))
        if name in ('phase', 'arg'):
            return torch.angle(self.tensor(v))
        raise MapSyntaxError("Unknown method .%s()" % name)

    def binop(self, op, lnode, rnode):
        lv = self.eval(lnode)
        rv = self.eval(rnode)
        if isinstance(lv, (IndexVec, ShapeVec)) or \
                isinstance(rv, (IndexVec, ShapeVec)):
            fn = _VEC_OPS[op]
            if isinstance(lv, (IndexVec, ShapeVec)):
                return lv.binop(fn, rv)
            return rv.binop(fn, lv, reverse=True)
        if isinstance(lv, Vec) or isinstance(rv, Vec):
            la = lv.arr if isinstance(lv, Vec) else \
                self.tensor(self.value(lv))[..., None]
            ra = rv.arr if isinstance(rv, Vec) else \
                self.tensor(self.value(rv))[..., None]
            return Vec(_apply_binop(self, op, la, ra))
        return _apply_binop(self, op, self.value(lv), self.value(rv))

    # -- statements ---------------------------------------------------------
    def run(self, body):
        for stmt in body:
            self.exec_stmt(stmt)

    def exec_stmt(self, stmt):
        torch = self.torch
        if stmt is None:
            return
        if isinstance(stmt, Decl):
            val = self.eval(stmt.expr) if stmt.expr is not None else 0
            if stmt.type_name != 'auto' and not isinstance(stmt.expr, Ctor):
                val = self.cast(val, stmt.type_name) \
                    if not isinstance(val, (Vec, IndexVec, ShapeVec)) else val
            self.env[stmt.name] = val
            return
        if isinstance(stmt, If):
            cond = self.tensor(self.value(self.eval(stmt.cond)))
            cond = cond.to(torch.bool)
            outer = self.mask
            self.mask = cond if outer is None else (outer & cond)
            self.run(stmt.then_body)
            if stmt.else_body:
                notc = torch.logical_not(cond)
                self.mask = notc if outer is None else (outer & notc)
                self.run(stmt.else_body)
            self.mask = outer
            return
        if isinstance(stmt, AssignCall):
            re = self.value(self.eval(stmt.args[0]))
            im = self.value(self.eval(stmt.args[1]))
            val = self.make_complex(torch.complex64, [re, im])
            self.store(stmt.target, '=', val)
            return
        if isinstance(stmt, Assign):
            if stmt.target is None:
                self.eval(stmt.expr)   # bare expression
                return
            val = self.eval(stmt.expr)
            self.store(stmt.target, stmt.op, val)
            return
        raise MapSyntaxError("Cannot execute %r" % stmt)

    def _combine(self, op, old, new):
        if op == '=':
            return new
        fn = {'+=': '+', '-=': '-', '*=': '*', '/=': '/'}[op]
        return _apply_binop(self, fn, old, new)

    def _fit(self, name, v, like):
        """``v`` converted to the type of output ``like`` (complex drops
        its imaginary part into a real output; unsigned outputs wrap)."""
        v = self.tensor(v)
        if v.is_complex() and not like.is_complex():
            v = v.real
        if name in self.unsigned:
            return self.astype(v, self.unsigned[name])
        return v.to(like.dtype)

    def store(self, target, op, val):
        torch = self.torch
        if isinstance(val, (IndexVec, ShapeVec)):
            val = self.value(val)
        if isinstance(target, Name):
            name = target.id
            if name in self.env:
                old = self.env[name]
                if isinstance(val, Vec) or isinstance(old, Vec):
                    va = val if isinstance(val, Vec) else Vec(
                        self.tensor(self.value(val))[..., None])
                    if op != '=':
                        olda = old.arr if isinstance(old, Vec) else old
                        va = Vec(_apply_binop(self, op[0], olda, va.arr))
                    self.env[name] = self.masked(va, old)
                else:
                    new = self._combine(op, self.value(old), self.value(val))
                    self.env[name] = self.masked(new, self.value(old))
                return
            if name in self.arrays or name in self.out:
                # whole-array elementwise store
                cur = self.out.get(name, self.arrays.get(name))
                veclen = self.veclens.get(name, 1)
                if isinstance(val, Vec):
                    new = val.arr.expand(cur.shape)
                else:
                    v = self.tensor(self.value(val))
                    tgt_shape = cur.shape[:-1] if veclen > 1 else cur.shape
                    new = v.expand(tgt_shape)
                    if veclen > 1:
                        new = new[..., None].expand(cur.shape)
                if op != '=':
                    new = self._combine(op, cur, new)
                new = self.masked(new, cur)
                self.out[name] = self._fit(name, new, cur)
                self.writable.discard(name)
                return
            # new local variable via plain assignment
            self.env[name] = self.masked(val, None)
            return
        if isinstance(target, CallIndex):
            name = target.base.id
            if name in self.env:
                raise MapSyntaxError("Cannot index-assign local %r" % name)
            cur = self.out.get(name, self.arrays.get(name))
            if cur is None:
                raise MapSyntaxError("Unknown output %r" % name)
            veclen = self.veclens.get(name, 1)
            ref = ArrayRef(name, cur, veclen)
            idx = self.build_index(ref, target.args)
            got = self.clamped(idx, cur.shape)
            v = val.arr if isinstance(val, Vec) else \
                self.tensor(self.value(val))
            if op != '=':
                v = self._combine(op, cur[got], v)
            if self.mask is not None:
                v = self.where(self.mask[..., None] if isinstance(val, Vec)
                               else self.mask, v, cur[got])
            v = self._fit(name, v, cur)
            if name not in self.writable:
                cur = cur.clone(memory_format=torch.contiguous_format)
                self.writable.add(name)
            ok = None
            for i, n in zip(idx, cur.shape):
                inside = (i >= 0) & (i < n)
                ok = inside if ok is None else ok & inside
            if bool(ok.all()):
                cur[idx] = v
            else:
                # a store out of range is dropped, as jnp's scatter
                s = ok.shape
                v = v.expand(s + tuple(cur.shape[len(idx):]))
                cur[tuple(i.expand(s)[ok] for i in idx)] = v[ok]
            self.out[name] = cur
            return
        if isinstance(target, Subscript):
            # component assignment on a local vector variable
            base = target.base
            if not isinstance(base, Name) or base.id not in self.env:
                raise MapSyntaxError("Unsupported subscript store")
            old = self.env[base.id]
            if not isinstance(old, Vec):
                raise MapSyntaxError("Subscript store on non-vector")
            k = self.value(self.eval(target.index))
            v = self.tensor(self.value(val))
            if op != '=':
                v = self._combine(op, old.arr[..., k], v)
            if self.mask is not None:
                v = self.where(self.mask, v, old.arr[..., k])
            arr = old.arr.clone(memory_format=torch.contiguous_format)
            arr[..., k] = v.to(arr.dtype)
            self.env[base.id] = Vec(arr)
            return
        raise MapSyntaxError("Bad assignment target %r" % target)


def _apply_binop(ev, op, a, b):
    torch = ev.torch
    if op == '+':
        return a + b
    if op == '-':
        return a - b
    if op == '*':
        return a * b
    if op == '/':
        if _is_int(a) and _is_int(b):
            return _cdiv(a, b)
        return a / b
    if op == '%':
        if _is_int(a) and _is_int(b):
            return _cmod(a, b)
        if not _is_tensor(a) and not _is_tensor(b):
            return math.fmod(a, b)
        return torch.fmod(*ev.pair(a, b))
    if op == '==':
        return a == b
    if op == '!=':
        return a != b
    if op == '<':
        return a < b
    if op == '<=':
        return a <= b
    if op == '>':
        return a > b
    if op == '>=':
        return a >= b
    if op == '&&':
        return torch.logical_and(ev.tensor(a), ev.tensor(b))
    if op == '||':
        return torch.logical_or(ev.tensor(a), ev.tensor(b))
    if op == '&':
        return a & b
    if op == '|':
        return a | b
    if op == '^':
        return a ^ b
    if op == '<<':
        return a << b
    if op == '>>':
        return a >> b
    raise MapSyntaxError("Unknown operator %r" % op)


_VEC_OPS = {
    '+': lambda a, b: a + b,
    '-': lambda a, b: a - b,
    '*': lambda a, b: a * b,
    '/': lambda a, b: a // b if isinstance(a, int) and isinstance(b, int)
    else _cdiv(a, b),
    '%': lambda a, b: a % b,
}


def _as_float(ev, x):
    x = ev.tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        return x.to(ev.torch.float32)
    return x


def _keep_ints(fn):
    """A rounding function that leaves integer values as they are."""
    def f(ev, x):
        x = ev.tensor(x)
        if x.is_floating_point():
            return fn(ev.torch)(x)
        return x
    return f


_FUNCS = {
    'abs': lambda ev, x: ev.torch.abs(ev.tensor(x)),
    'fabs': lambda ev, x: ev.torch.abs(ev.tensor(x)),
    'sqrt': lambda ev, x: ev.torch.sqrt(_as_float(ev, x)),
    'rsqrt': lambda ev, x: 1.0 / ev.torch.sqrt(_as_float(ev, x)),
    'exp': lambda ev, x: ev.torch.exp(_as_float(ev, x)),
    'exp2': lambda ev, x: ev.torch.exp2(_as_float(ev, x)),
    'log': lambda ev, x: ev.torch.log(_as_float(ev, x)),
    'log2': lambda ev, x: ev.torch.log2(_as_float(ev, x)),
    'log10': lambda ev, x: ev.torch.log10(_as_float(ev, x)),
    'sin': lambda ev, x: ev.torch.sin(_as_float(ev, x)),
    'cos': lambda ev, x: ev.torch.cos(_as_float(ev, x)),
    'tan': lambda ev, x: ev.torch.tan(_as_float(ev, x)),
    'asin': lambda ev, x: ev.torch.asin(_as_float(ev, x)),
    'acos': lambda ev, x: ev.torch.acos(_as_float(ev, x)),
    'atan': lambda ev, x: ev.torch.atan(_as_float(ev, x)),
    'atan2': lambda ev, y, x: ev.torch.atan2(_as_float(ev, y),
                                             _as_float(ev, x)),
    'pow': lambda ev, x, y: ev.torch.pow(*ev.pair(x, y)),
    'rint': _keep_ints(lambda torch: torch.round),
    'round': _keep_ints(lambda torch: torch.round),
    'floor': _keep_ints(lambda torch: torch.floor),
    'ceil': _keep_ints(lambda torch: torch.ceil),
    'trunc': _keep_ints(lambda torch: torch.trunc),
    'min': lambda ev, a, b: ev.torch.minimum(*ev.pair(a, b)),
    'max': lambda ev, a, b: ev.torch.maximum(*ev.pair(a, b)),
    'fmin': lambda ev, a, b: ev.torch.fmin(*ev.pair(a, b)),
    'fmax': lambda ev, a, b: ev.torch.fmax(*ev.pair(a, b)),
    'erf': lambda ev, x: ev.torch.special.erf(_as_float(ev, x)),
    'conj': lambda ev, x: ev.torch.conj_physical(ev.tensor(x)),
}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _find_outputs(body, data_names):
    """Names assigned at top level that refer to data arrays."""
    outs = []

    def walk(stmts):
        for s in stmts:
            if s is None:
                continue
            if isinstance(s, (Assign, AssignCall)):
                t = s.target
                if isinstance(t, CallIndex):
                    t = t.base
                if isinstance(t, Subscript):
                    t = t.base
                if isinstance(t, Name) and t.id in data_names \
                        and t.id not in outs:
                    outs.append(t.id)
            elif isinstance(s, If):
                walk(s.then_body)
                walk(s.else_body)

    walk(body)
    return outs


def _storage_logical(buf, dt, device):
    """Host storage of DataType ``dt`` -> a tensor of its logical values
    on ``device``: the storage bytes cross as they are (packed types
    packed) and are unpacked on the device."""
    from ..devrep import to_device_rep
    from .common import complexify
    return complexify(to_device_rep(buf, dt, device), dt)


def _prep_array(x, device):
    """(logical tensor on ``device``, DataType) of an array argument: a
    tensor, the port's host ``ndarray`` or a numpy array."""
    import torch
    from ..ndarray import ndarray
    if isinstance(x, torch.Tensor):
        return x.to(device), DataType(
            torch.empty(0, dtype=x.dtype).numpy().dtype)
    if isinstance(x, ndarray):
        return _storage_logical(x.as_numpy(), x.dtype, device), x.dtype
    dt = DataType(x.dtype)
    return _storage_logical(x, dt, device), dt


def _widen(t):
    """Unsigned 16/32-bit tensors compute in int64."""
    import torch
    if t.dtype in (torch.uint16, torch.uint32):
        return t.to(torch.int64)
    return t


def map_compute(func_string, data, axis_names=None, shape=None):
    """Functional core: returns {output_name: tensor of logical values}
    without writing back.  Arrays in ``data`` may be tensors, the port's
    host ``ndarray`` (any bifrost dtype, packed and complex-integer types
    included), numpy arrays, or Python scalars."""
    from ..device import get_device
    device = get_device()
    arrays, scalars, dtypes, unsigned = {}, {}, {}, {}
    for name, x in data.items():
        if isinstance(x, (int, float, complex)) and not isinstance(x, bool):
            scalars[name] = x
            continue
        if not hasattr(x, 'shape'):
            x = np.asarray(x)
        if isinstance(x, (np.ndarray, np.generic)) and x.ndim == 0:
            scalars[name] = x.item()
            continue
        arrays[name], dtypes[name] = _prep_array(x, device)
        u = _logical_dtype(dtypes[name])
        if isinstance(u, _Unsigned):
            unsigned[name] = u

    # the port has no vector types: every array's vector length is 1
    key_arrays = tuple(sorted(
        (n, tuple(a.shape), _dtype_name(a.dtype), 1)
        for n, a in arrays.items()))
    arrays = {n: _widen(a) for n, a in arrays.items()}

    pkey = (func_string, tuple(data.keys()), tuple(sorted(arrays)))
    hit = _parsed.get(pkey)
    if hit is None:
        body = compile_map(func_string, list(data.keys()))
        hit = _parsed.put(pkey, (body, tuple(_find_outputs(body,
                                                           set(arrays)))))
    body, outputs = hit

    if shape is None:
        # elementwise mode: iteration space = broadcast of non-output arrays
        shapes = [tuple(a.shape) for n, a in arrays.items()
                  if n not in outputs]
        if not shapes:
            shapes = [tuple(arrays[outputs[0]].shape)] if outputs else [()]
        it_shape = np.broadcast_shapes(*shapes) if shapes else ()
    else:
        it_shape = tuple(int(s) for s in shape)

    _keys.put((func_string, key_arrays, tuple(sorted(scalars)),
               tuple(axis_names or ()), tuple(it_shape)), True)

    ev = _Eval(it_shape, axis_names, dict(arrays), dict(scalars), dtypes,
               {}, device=device, unsigned=unsigned)
    for o in outputs:
        ev.out[o] = ev.arrays.pop(o)
    for o in outputs:
        # an output is written in place (the caller's own tensor, or the
        # copy this call made of a host array) unless its storage is
        # shared with another argument
        if not any(_overlaps(ev.out[o], a)
                   for a in list(ev.arrays.values()) +
                   [ev.out[n] for n in outputs if n != o]):
            ev.writable.add(o)
    ev.run(body)
    return {o: ev.out[o] for o in outputs}


def _overlaps(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _to_device_rep(t, dt):
    """Logical tensor -> the device representation of DataType ``dt``
    (integer targets round half to even and wrap; complex integers per
    component), as ``_from_logical`` converts on the host."""
    import torch
    if dt.kind == 'ci':
        re = torch.round(_real(t).to(torch.float64)).to(torch.int64)
        im = torch.round(_imag(t).to(torch.float64)).to(torch.int64)
        return torch.stack([re, im], dim=-1).to(dt.as_torch_dtype())
    if dt.kind == 'cf':
        return t.to(torch.complex128 if dt.nbits > 32 else torch.complex64)
    if t.is_complex():
        t = t.real
    if dt.kind in ('i', 'u'):
        if t.is_floating_point():
            t = torch.round(t)
        t = t.to(torch.int64)
        if dt.kind == 'u' and dt.nbits in (16, 32):
            return t & ((1 << dt.nbits) - 1)   # numpy casts it on the host
        return t.to(dt.as_torch_dtype())
    return t.to(dt.as_torch_dtype())


def _write_host(res, dt, buf):
    """Write logical tensor ``res`` into host storage ``buf`` of DataType
    ``dt`` (packed types pack on the device, ``devrep.pack_tensor``)."""
    from ..devrep import from_device_rep
    return from_device_rep(_to_device_rep(res, dt).contiguous(), dt, buf)


def map(func_string, data=None, axis_names=None, shape=None, func_name=None,
        extra_code=None, block_shape=None, block_axes=None, **kwargs):
    """Apply a user-defined transformation to arrays (reference:
    python/bifrost/map.py:58-143).  Output arrays named in ``data`` are
    updated: a tensor in place, a host array (the port's ``ndarray`` or
    numpy) by writing its storage.  Also returns the dict of computed
    outputs.  ``func_name``/``extra_code``/``block_shape``/``block_axes``
    are accepted for API compatibility and ignored, as in the JAX
    package."""
    import torch
    from ..ndarray import ndarray
    if data is None:
        data = kwargs
    results = map_compute(func_string, data, axis_names=axis_names,
                          shape=shape)
    for name, res in results.items():
        holder = data[name]
        if isinstance(holder, torch.Tensor):
            if res is not holder:
                holder.copy_(res)
        elif isinstance(holder, ndarray):
            _write_host(res, holder.dtype, holder.as_numpy())
        elif isinstance(holder, np.ndarray):
            _write_host(res, DataType(holder.dtype), holder)
    return results
