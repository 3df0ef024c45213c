"""NDArray over ``torch.Tensor``, and the ``.params`` container format.

The port of the parts of ``mxnet_tpu/ndarray.py`` the serving and
training slices use: an :class:`NDArray` handle with mutable-handle
semantics (``x[:] = v`` swaps in a new value; ``x[a:b]`` reads rows),
``array``/``zeros``/``concatenate`` creation, and
:func:`save`/:func:`load`, which read and write the JAX package's
``.params`` container byte for byte (``mxnet_tpu/ndarray.py:405-517``,
magic ``MXTPU001``): a checkpoint written by either package loads in the
other.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .base import MXNetError, resolve_dtype
from .context import Context, cpu

__all__ = ['NDArray', 'array', 'zeros', 'concatenate', 'save', 'load']


class NDArray:
    """Handle to a tensor on one device."""

    __slots__ = ('_data', '_ctx')

    def __init__(self, data: torch.Tensor, ctx: Context):
        self._data = data
        self._ctx = ctx

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    def asnumpy(self) -> np.ndarray:
        """A host copy (waits for the device).  bfloat16 has no numpy
        dtype and comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def as_in_context(self, context: Context):
        """This array on ``context`` (itself when already there)."""
        if context == self._ctx:
            return self
        return NDArray(self._data.to(context.torch_device), context)

    def _set_data(self, new_data):
        self._data = new_data

    def __getitem__(self, key):
        """Rows ``x[a:b]`` (a slice of the first axis) as a new
        NDArray."""
        if not isinstance(key, slice):
            raise MXNetError('NDArray indexing takes a slice of the first '
                             'axis')
        return NDArray(self._data[key], self._ctx)

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, whose device and dtype are
        kept) or onto a Context (a new NDArray)."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True),
                           other)
        if other.shape != self.shape:
            raise MXNetError('copyto: shape %s into %s'
                             % (self.shape, other.shape))
        other._set_data(self._data.to(device=other.handle.device,
                                      dtype=other.dtype, copy=True))
        return other

    def __setitem__(self, key, value):
        if key != slice(None) and key is not Ellipsis:
            raise MXNetError('NDArray supports whole-array assignment '
                             '(x[:] = v) only')
        if isinstance(value, NDArray):
            value = value._data
        src = torch.as_tensor(np.asarray(value)) \
            if not isinstance(value, torch.Tensor) else value
        self._set_data(torch.broadcast_to(
            src.to(device=self._data.device, dtype=self._data.dtype),
            self.shape).contiguous())

    def __repr__(self):
        return '<NDArray %s @%s>' % ('x'.join(str(s) for s in self.shape),
                                     self._ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (default
    ``cpu()``, as in the reference).  The default dtype is float32
    (float64 sources included), as in the reference."""
    ctx = ctx if ctx is not None else cpu()
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


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx if ctx is not None else cpu()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=resolve_dtype(dtype),
                               device=ctx.torch_device), ctx)


def concatenate(arrays, axis=0):
    """Join NDArrays along ``axis`` on the first array's context."""
    ctx = arrays[0].context
    dev = arrays[0].handle.device
    return NDArray(torch.cat([a.handle.to(dev) for a in arrays], dim=axis),
                   ctx)


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
        for _ in range(n_arrays):
            dtlen, = struct.unpack('<q', _read(f, 8))
            dt = np.dtype(_read(f, dtlen).decode())
            ndim, = struct.unpack('<q', _read(f, 8))
            shape = tuple(struct.unpack('<q', _read(f, 8))[0]
                          for _ in range(ndim))
            blen, = struct.unpack('<q', _read(f, 8))
            npa = np.frombuffer(_read(f, blen), dtype=dt).reshape(shape)
            arrays.append(array(npa, ctx))
    if keys:
        return dict(zip(keys, arrays))
    return arrays
