"""Shared plumbing: errors, name scoping, attr scoping, dtype maps.

The PyTorch counterpart of ``mxnet_tpu/base.py``: the pure-Python
utilities of the reference's ``python/mxnet/base.py``, ``name.py`` and
``attribute.py``.  Dtypes resolve to ``torch.dtype`` here.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ['MXNetError', 'NameManager', 'AttrScope', 'resolve_dtype']


class MXNetError(Exception):
    """Error raised by the framework (reference ``base.py:MXNetError``)."""


class _ScopedSingleton:
    _tls = None  # subclass provides its own threading.local()

    @classmethod
    def current(cls):
        cur = getattr(cls._tls, 'value', None)
        if cur is None:
            cur = cls()
            cls._tls.value = cur
        return cur

    def __enter__(self):
        self._old = getattr(type(self)._tls, 'value', None)
        type(self)._tls.value = self
        return self

    def __exit__(self, ptype, value, trace):
        type(self)._tls.value = self._old


class NameManager(_ScopedSingleton):
    """Automatic symbol naming, mirroring ``python/mxnet/name.py:10-70``."""

    _tls = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = '%s%d' % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name


class AttrScope(_ScopedSingleton):
    """Scoped symbol attributes (``python/mxnet/attribute.py:9-60``)."""

    _tls = threading.local()

    def __init__(self, **kwargs):
        self._attr = {str(k): str(v) for k, v in kwargs.items()}

    def __enter__(self):
        # nested scopes inherit the enclosing scope's attributes
        ret = super().__enter__()
        if self._old is not None:
            merged = dict(self._old._attr)
            merged.update(self._attr)
            self._attr = merged
        return ret

    def get(self, attr):
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged


_DTYPES = {
    'float32': torch.float32, 'float64': torch.float64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'uint8': torch.uint8, 'int8': torch.int8, 'int32': torch.int32,
    'int64': torch.int64, 'bool': torch.bool,
}


def resolve_dtype(dtype):
    """Normalize a dtype spec (None, a name, a numpy dtype or a
    ``torch.dtype``) to a ``torch.dtype``; None means float32, the
    reference's ``mx_real_t``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError('unsupported dtype %r' % (dtype,)) from None
