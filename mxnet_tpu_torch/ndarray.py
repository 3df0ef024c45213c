"""NDArray over ``torch.Tensor``, the imperative ``nd.*`` layer, and the
``.params`` container format.

The port of ``mxnet_tpu/ndarray.py``: an :class:`NDArray` handle with
the JAX package's mutable-handle semantics, its arithmetic, comparison
and in-place operators (``:243-285``), general indexing (``:212-231``),
the creation functions (``:308-397``), the imperative op dispatch
:func:`imperative_invoke` (``:546-642``) and the ``nd.<op>`` namespace
over every registered operator (``:645-740``), and :func:`save` /
:func:`load`, which read and write the JAX package's ``.params``
container byte for byte (``:405-517``, magic ``MXTPU001``): a
checkpoint written by either package loads in the other.

Handle semantics: ``x[k] = v``, ``x += y``, ``x[:] = v`` and an op's
``out=`` swap a new tensor into the handle (``_set_data``); they never
write through a tensor that another NDArray may share.  ``x[k]`` is a
copy, not a view: a later write to ``x`` leaves it as it was.

The JAX package jit-compiles each imperative op once per (op, attrs)
and keeps the programs in an LRU (``:532-621``).  PyTorch runs eagerly:
each ``nd.<op>`` call runs the op's registered function on the inputs'
device, under ``torch.no_grad()``, and there is no cache.  Its inputs
must lie on one device (mixed contexts raise, as in the JAX package and
the reference).  ``array`` and ``zeros`` default to
:func:`~context.current_context` (``cpu(0)`` outside a ``with`` scope);
``ones``, ``full``, ``empty``, ``arange`` and ops with no input array
default to :func:`~context.compute_context` (``gpu(0)`` outside a scope).
"""
from __future__ import annotations

import builtins
import os
import struct

import numpy as np
import torch

from .base import _DTYPES, MXNetError, resolve_dtype
from .context import (Context, as_torch_device, compute_context, context_of,
                      current_context)
from .ops import get_op, list_ops

__all__ = ['NDArray', 'array', 'zeros', 'ones', 'full', 'empty', 'arange',
           'concatenate', 'save', 'load', 'validate', 'imperative_invoke',
           'waitall',
           'onehot_encode', 'maximum', 'minimum', 'power']


def _scalar(v):
    return v.item() if isinstance(v, np.generic) else v


class NDArray:
    """Handle to a tensor on one device, with mutable-handle semantics."""

    __slots__ = ('_data', '_ctx')
    # numpy defers binary ops (np_scalar * NDArray) to the reflected ones
    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor, ctx: Context = None):
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data.device)

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def T(self):
        return NDArray(self._data.permute(
            tuple(range(self.ndim - 1, -1, -1))).contiguous(), self._ctx)

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    # -- sync points -------------------------------------------------------
    def wait_to_read(self):
        """Wait until the device has computed this array."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy (waits for the device).  bfloat16 has no numpy
        dtype and comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError('The current array is not a scalar')
        return self.asnumpy().reshape(())[()]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- conversion / movement ---------------------------------------------
    def astype(self, dtype):
        return NDArray(self._data.to(resolve_dtype(dtype)), self._ctx)

    def as_in_context(self, context: Context):
        """This array on ``context`` (itself when already there)."""
        if context == self._ctx:
            return self
        return NDArray(self._data.to(context.torch_device), context)

    def _set_data(self, new_data):
        self._data = new_data

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, whose device and dtype are
        kept) or onto a Context (a new NDArray)."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True),
                           other)
        if other is self:
            raise MXNetError('copy an array to itself, is it intended?')
        if other.shape != self.shape:
            raise MXNetError('copyto: shape %s into %s'
                             % (self.shape, other.shape))
        other._set_data(self._data.to(device=other.handle.device,
                                      dtype=other.dtype, copy=True))
        return other

    # -- indexing ----------------------------------------------------------
    def _index(self, key):
        if isinstance(key, NDArray):
            return key._data.long().to(self._data.device)
        if isinstance(key, np.ndarray):
            return torch.from_numpy(key).to(self._data.device)
        return key

    def _value(self, value):
        """``value`` as a tensor (or a Python number) for this array."""
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            return value.to(device=self._data.device, dtype=self._data.dtype)
        if np.isscalar(value):
            return _scalar(value)
        return torch.as_tensor(np.asarray(value)).to(
            device=self._data.device, dtype=self._data.dtype)

    def __getitem__(self, key):
        out = self._data[self._index(key)]
        # a copy: the JAX package's x[k] is a new value, unmoved by later
        # writes to x (the fused step updates parameters in place)
        return NDArray(out.clone() if out._is_view() else out, self._ctx)

    def __setitem__(self, key, value):
        value = self._value(value)
        if key == builtins.slice(None) or key is Ellipsis:
            if isinstance(value, torch.Tensor):
                self._set_data(torch.broadcast_to(value, self.shape)
                               .contiguous())
            else:
                self._set_data(torch.full(self.shape, value,
                                          dtype=self._data.dtype,
                                          device=self._data.device))
            return
        new = self._data.clone()
        new[self._index(key)] = value
        self._set_data(new)

    def slice(self, start, stop):
        return self[start:stop]

    def reshape(self, shape):
        return NDArray(torch.reshape(self._data, tuple(shape)), self._ctx)

    def broadcast_to(self, shape):
        return NDArray(torch.broadcast_to(self._data, tuple(shape))
                       .contiguous(), self._ctx)

    # -- arithmetic --------------------------------------------------------
    def _operand(self, other):
        if isinstance(other, NDArray):
            if other._data.device != self._data.device:
                raise MXNetError('operands on %s and %s: move one with '
                                 'as_in_context / copyto'
                                 % (self._ctx, other._ctx))
            return other._data
        if isinstance(other, (np.ndarray, list, tuple)):
            t = torch.as_tensor(np.asarray(other))
            # JAX without x64: a float64 operand computes in float32
            if t.dtype == torch.float64:
                t = t.float()
            return t.to(self._data.device)
        return _scalar(other)

    def _binary(self, other, fn):
        with torch.no_grad():
            return NDArray(fn(self._data, self._operand(other)), self._ctx)

    def __add__(self, o): return self._binary(o, torch.add)
    __radd__ = __add__
    def __sub__(self, o): return self._binary(o, torch.sub)
    def __rsub__(self, o): return self._binary(o, lambda a, b: b - a)
    def __mul__(self, o): return self._binary(o, torch.mul)
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binary(o, torch.div)
    def __rtruediv__(self, o): return self._binary(o, lambda a, b: b / a)
    __div__ = __truediv__
    __rdiv__ = __rtruediv__
    # jnp.mod takes the divisor's sign, as torch.remainder does
    def __mod__(self, o): return self._binary(o, torch.remainder)
    def __pow__(self, o): return self._binary(o, torch.pow)
    def __neg__(self): return NDArray(-self._data, self._ctx)
    def __abs__(self): return NDArray(torch.abs(self._data), self._ctx)

    def __iadd__(self, o):
        self._set_data((self + o)._data)
        return self

    def __isub__(self, o):
        self._set_data((self - o)._data)
        return self

    def __imul__(self, o):
        self._set_data((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data((self / o)._data)
        return self

    # comparisons give 0/1 in the lhs dtype
    def _compare(self, o, fn):
        return self._binary(o, lambda a, b: fn(a, b).to(a.dtype))

    def __eq__(self, o):
        if not isinstance(o, (NDArray, np.ndarray, int, float)):
            return NotImplemented
        return self._compare(o, torch.eq)

    def __ne__(self, o):
        if not isinstance(o, (NDArray, np.ndarray, int, float)):
            return NotImplemented
        return self._compare(o, torch.ne)

    def __gt__(self, o): return self._compare(o, torch.gt)
    def __ge__(self, o): return self._compare(o, torch.ge)
    def __lt__(self, o): return self._compare(o, torch.lt)
    def __le__(self, o): return self._compare(o, torch.le)

    def __hash__(self):
        return id(self)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return '<NDArray %s @%s>' % ('x'.join(str(s) for s in self.shape),
                                     self._ctx)

    def __getstate__(self):
        return {'data': self.asnumpy(), 'dtype': str(self.dtype),
                'ctx_type': self._ctx.device_type,
                'ctx_id': self._ctx.device_id}

    def __setstate__(self, state):
        # the JAX package's state has no 'dtype' (the array's own) and
        # may name a device type the port has not ('tpu': the host then)
        ctx_type = state['ctx_type']
        ctx = Context(ctx_type if ctx_type in Context.devstr2type else 'cpu',
                      state['ctx_id'] if ctx_type in Context.devstr2type
                      else 0)
        data = np.asarray(state['data'])
        dtype = state.get('dtype')
        self._ctx = ctx
        self._data = torch.from_numpy(data.copy()).to(
            device=ctx.torch_device,
            dtype=resolve_dtype(dtype.replace('torch.', '')) if dtype
            else resolve_dtype(data.dtype))


def waitall():
    """Wait until every device has finished its queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _ctx(ctx):
    return ctx if ctx is not None else current_context()


def _compute_ctx(ctx):
    return ctx if ctx is not None else compute_context()


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (default
    the current context, ``cpu(0)`` unless a ``with`` scope sets one).
    The default dtype is the source's, float32 for a float64 source or
    one without a dtype (a list), as in the reference."""
    ctx = _ctx(ctx)
    if dtype is None and getattr(source_array, 'dtype', None) is None:
        dtype = torch.float32
    if isinstance(source_array, NDArray):
        source_array = source_array.handle
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach().clone()
    else:
        # a private, writable, C-ordered copy
        t = torch.from_numpy(np.array(source_array, order='C'))
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    t = t.to(device=ctx.torch_device,
             dtype=resolve_dtype(dtype) if dtype is not None else t.dtype)
    return NDArray(t, ctx)


def _shape_tuple(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(shape)


def zeros(shape, ctx=None, dtype=None):
    ctx = _ctx(ctx)
    return NDArray(torch.zeros(_shape_tuple(shape), dtype=resolve_dtype(dtype),
                               device=ctx.torch_device), ctx)


def ones(shape, ctx=None, dtype=None):
    ctx = _compute_ctx(ctx)
    return NDArray(torch.ones(_shape_tuple(shape), dtype=resolve_dtype(dtype),
                              device=ctx.torch_device), ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = _compute_ctx(ctx)
    return NDArray(torch.full(_shape_tuple(shape), val,
                              dtype=resolve_dtype(dtype),
                              device=ctx.torch_device), ctx)


def empty(shape, ctx=None, dtype=None):
    """Zeros, as in the JAX package (its arrays have no uninitialized
    state)."""
    return zeros(shape, _compute_ctx(ctx), dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    from .ops.tensor import arange as _arange
    ctx = _compute_ctx(ctx)
    return NDArray(_arange(start, stop, step, repeat, dtype,
                           ctx.torch_device), ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along ``axis`` on the first array's context."""
    if not always_copy and len(arrays) == 1:
        return arrays[0]
    ctx = arrays[0].context
    dev = arrays[0].handle.device
    return NDArray(torch.cat([a.handle.to(dev) for a in arrays], dim=axis),
                   ctx)


def onehot_encode(indices, out):
    """Legacy one-hot (ndarray.cc _onehot_encode) into ``out``."""
    depth = out.shape[1]
    idx = indices.handle.long().to(out.handle.device)
    hot = idx[:, None] == torch.arange(depth, device=idx.device)
    out._set_data(hot.to(out.dtype))
    return out


_MAGIC = b'MXTPU001'


def _as_numpy(a):
    if isinstance(a, NDArray):
        if a.dtype == torch.bfloat16:
            raise MXNetError('.params stores numpy dtypes; cast bfloat16 '
                             'arrays to float32 before saving')
        return a.asnumpy()
    return np.asarray(a)


def save(fname, data):
    """Save a list or str->NDArray dict in the ``MXTPU001`` container."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    else:
        keys = []
        arrays = list(data)
    with open(fname, 'wb') as f:
        f.write(_MAGIC)
        f.write(struct.pack('<q', len(arrays)))
        f.write(struct.pack('<q', len(keys)))
        for k in keys:
            kb = k.encode()
            f.write(struct.pack('<q', len(kb)))
            f.write(kb)
        for a in arrays:
            npa = _as_numpy(a)
            dt = npa.dtype.str.encode()
            f.write(struct.pack('<q', len(dt)))
            f.write(dt)
            f.write(struct.pack('<q', npa.ndim))
            for s in npa.shape:
                f.write(struct.pack('<q', s))
            buf = npa.tobytes()
            f.write(struct.pack('<q', len(buf)))
            f.write(buf)


def _read(f, n):
    b = f.read(n)
    if len(b) != n:
        raise MXNetError('truncated NDArray file')
    return b


def validate(fname):
    """Whether ``fname`` is a whole ``MXTPU001`` container: walks the
    headers and checks that every byte they promise is there, without
    building the arrays (``mxnet_tpu/ndarray.py:440``).  A truncated or
    torn file gives False; never raises."""
    try:
        with open(fname, 'rb') as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                return False
            n_arrays, = struct.unpack('<q', _read(f, 8))
            n_keys, = struct.unpack('<q', _read(f, 8))
            if not (0 <= n_arrays < 1 << 32 and 0 <= n_keys < 1 << 32):
                return False
            if n_keys and n_keys != n_arrays:
                return False
            for _ in range(n_keys):
                klen, = struct.unpack('<q', _read(f, 8))
                if not 0 <= klen < 1 << 20:
                    return False
                _read(f, klen)
            for _ in range(n_arrays):
                dtlen, = struct.unpack('<q', _read(f, 8))
                if not 0 < dtlen < 64:
                    return False
                dt = np.dtype(_read(f, dtlen).decode())
                ndim, = struct.unpack('<q', _read(f, 8))
                if not 0 <= ndim < 64:
                    return False
                shape = [struct.unpack('<q', _read(f, 8))[0]
                         for _ in range(ndim)]
                blen, = struct.unpack('<q', _read(f, 8))
                if blen != int(np.prod(shape, dtype=np.int64)) * dt.itemsize:
                    return False
                f.seek(blen, 1)
                if f.tell() > os.fstat(f.fileno()).st_size:
                    return False
            return True
    except Exception:           # noqa: BLE001 - any damage reads False
        return False


def load(fname, ctx=None):
    """Load a ``MXTPU001`` container: a dict when it has keys, else a
    list.  Arrays land on ``ctx`` (default ``cpu()``)."""
    with open(fname, 'rb') as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise MXNetError('invalid NDArray file format: %s' % fname)
        n_arrays, = struct.unpack('<q', _read(f, 8))
        n_keys, = struct.unpack('<q', _read(f, 8))
        if n_keys and n_keys != n_arrays:
            raise MXNetError('corrupt NDArray file: %d keys for %d arrays'
                             % (n_keys, n_arrays))
        keys = []
        for _ in range(n_keys):
            klen, = struct.unpack('<q', _read(f, 8))
            keys.append(_read(f, klen).decode())
        arrays = []
        for i in range(n_arrays):
            dtlen, = struct.unpack('<q', _read(f, 8))
            dt_str = _read(f, dtlen).decode()
            dt = np.dtype(dt_str)
            if dt.name not in _DTYPES:
                # e.g. the reference's bfloat16 entries, stored as '<V2'
                raise MXNetError('cannot load entry %r of %s: dtype %r has '
                                 'no NDArray type'
                                 % (keys[i] if keys else i, fname, dt_str))
            ndim, = struct.unpack('<q', _read(f, 8))
            shape = tuple(struct.unpack('<q', _read(f, 8))[0]
                          for _ in range(ndim))
            blen, = struct.unpack('<q', _read(f, 8))
            npa = np.frombuffer(_read(f, blen), dtype=dt).reshape(shape)
            arrays.append(array(npa, ctx))
    if keys:
        return dict(zip(keys, arrays))
    return arrays


# ---------------------------------------------------------------------------
# Imperative op dispatch (MXImperativeInvoke)
# ---------------------------------------------------------------------------

def imperative_invoke(op_name: str, *args, out=None, name=None, **kwargs):
    """Run registered op ``op_name`` on NDArrays: positional arrays, then
    trailing positional attrs in the op's ``arg_order``; keyword NDArrays
    are named inputs, other keywords attrs; ``ctx`` places an op with no
    input array (default :func:`~context.compute_context`); ``out`` (an
    NDArray or a list) receives the results.  Inputs on more than one
    device raise."""
    op = get_op(op_name)
    if args and not isinstance(args[-1], NDArray) and \
            'num_args' not in op.attr_defaults:
        n_arr = len(args)
        while n_arr and not isinstance(args[n_arr - 1], NDArray):
            n_arr -= 1
        extra = args[n_arr:]
        args = args[:n_arr]
        free_attrs = [k for k in op.arg_order if k not in kwargs]
        if len(extra) > len(free_attrs):
            raise MXNetError('too many positional args for op %s'
                             % op_name)
        kwargs.update(zip(free_attrs, extra))
    ctx = kwargs.pop('ctx', None)
    attrs = {}
    named_inputs = {}
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            named_inputs[k] = v
        else:
            attrs[k] = v
    cattrs = op.canon_attrs({k: v for k, v in attrs.items() if v is not None})
    if 'num_args' in op.attr_defaults and args:
        cattrs['num_args'] = len(args)
    inputs = list(args)
    if named_inputs:
        in_names = op.input_names(cattrs) + op.aux_names(cattrs)
        pos = {n: i for i, n in enumerate(in_names)}
        merged = inputs + [None] * (len(in_names) - len(inputs))
        for k, v in named_inputs.items():
            if k not in pos:
                raise MXNetError('unknown input %r for op %s' % (k, op_name))
            merged[pos[k]] = v
        inputs = [m for m in merged if m is not None]
    if inputs:
        devices = {a.handle.device for a in inputs}
        if len(devices) > 1:
            raise MXNetError('op %s: inputs on more than one device (%s); '
                             'move them with as_in_context / copyto' % (
                                 op_name, ', '.join(sorted(
                                     str(a.context) for a in inputs))))
        ctx = inputs[0].context
    else:
        ctx = Context(ctx) if isinstance(ctx, Context) else (
            context_of(as_torch_device(ctx)) if ctx is not None
            else compute_context())
        ctx.torch_device        # a gpu context raises on a host without CUDA
        cattrs['ctx'] = ctx
    with torch.no_grad():
        raw, _ = op.apply(cattrs, [a.handle for a in inputs], True, None)
    outs = [NDArray(r, ctx) for r in raw]
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(out_list, outs):
            if op.out_in_place and dst.shape == src.shape and \
                    dst.handle.device == src.handle.device:
                dst.handle.copy_(src._data)
            else:
                dst._set_data(src._data)
        return out
    if len(outs) == 1:
        return outs[0]
    return outs


def _make_invoke(op_name):
    def invoke(*args, **kwargs):
        return imperative_invoke(op_name, *args, **kwargs)
    invoke.__name__ = op_name
    invoke.__qualname__ = op_name
    invoke.__doc__ = get_op(op_name).doc
    return invoke


def _install_ops(namespace):
    """Expose registered ops as module-level functions, like the
    reference's generated ``mxnet.ndarray`` module.  Names this module
    defines keep their definition; names with a leading underscore
    (other than the samplers) stay reachable through ``__getattr__``.
    NB: this installs ``slice``, ``max``, ``min``, ``sum``, ``abs`` and
    ``round`` over the builtins here: code below uses ``builtins.*``."""
    for opname in list_ops():
        if opname.startswith('_') and not opname.startswith('_random'):
            continue
        if opname in namespace:
            continue
        namespace[opname] = _make_invoke(opname)


_install_ops(globals())


def _scalar_or_broadcast(lhs, rhs, broadcast_op, scalar_op,
                         rscalar_op=None):
    """The reference's maximum / minimum / power helpers: dispatch on
    scalar-ness, broadcast otherwise."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return imperative_invoke(broadcast_op, lhs, rhs)
    if isinstance(lhs, NDArray):
        return imperative_invoke(scalar_op, lhs, scalar=float(rhs))
    if isinstance(rhs, NDArray):
        return imperative_invoke(rscalar_op or scalar_op, rhs,
                                 scalar=float(lhs))
    fn = {'broadcast_maximum': builtins.max,
          'broadcast_minimum': builtins.min,
          'broadcast_power': builtins.pow}[broadcast_op]
    return fn(lhs, rhs)


def maximum(lhs, rhs):
    """Element-wise broadcasting maximum (reference ndarray.py:1315)."""
    return _scalar_or_broadcast(lhs, rhs, 'broadcast_maximum',
                                '_maximum_scalar')


def minimum(lhs, rhs):
    """Element-wise broadcasting minimum (reference ndarray.py:1358)."""
    return _scalar_or_broadcast(lhs, rhs, 'broadcast_minimum',
                                '_minimum_scalar')


def power(base, exp):
    """Element-wise broadcasting power (reference ndarray.py:1272)."""
    return _scalar_or_broadcast(base, exp, 'broadcast_power',
                                '_power_scalar', '_rpower_scalar')


def __getattr__(name):
    """Resolve ops registered after import (``Custom``, user ops) and the
    underscore ops."""
    try:
        get_op(name)
    except KeyError:
        raise AttributeError('module %r has no attribute %r'
                             % (__name__, name)) from None
    globals()[name] = _make_invoke(name)
    return globals()[name]
