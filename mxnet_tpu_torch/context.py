"""Device context.

The PyTorch counterpart of ``mxnet_tpu/context.py``.  A ``Context`` names
a logical device, ``cpu(i)`` or ``gpu(i)``, and resolves to a
``torch.device``.  A ``gpu`` context on a host without a CUDA device
raises when it is resolved: nothing in the port quietly runs a GPU
request on the CPU.

A Context is also a ``with`` target that sets the thread-local default
of :func:`current_context` (``mxnet_tpu/context.py:55-61,107-110``).
Outside any scope the two kinds of imperative entry point differ:

- ``nd.array`` and ``nd.zeros`` (and ``nd.load``) put their arrays on
  :func:`current_context`, ``cpu(0)`` as in the JAX package and the
  reference MXNet: they are the host containers every params dict is
  built in;
- everything else that makes an array from no input array (``nd.ones``,
  ``nd.full``, ``nd.empty``, ``nd.arange``, ``mx.random.*`` and every
  ``nd.<op>`` with no input) runs on :func:`compute_context`, the card
  ``gpu(0)``, and raises on a host without CUDA unless the caller asks
  for the CPU (``ctx=cpu()`` or ``with mx.cpu():``).

The compute entry points (``Module``, ``Predictor``, ``ModelServer``)
default to the card too.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context:
    """A logical device, e.g. ``Context('gpu', 0)``."""

    devtype2str = {1: 'cpu', 2: 'gpu'}
    devstr2type = {'cpu': 1, 'gpu': 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("device type must be 'cpu' or 'gpu', "
                                 'got %r' % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context) and
                self.device_typeid == other.device_typeid and
                self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return '%s(%d)' % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, 'value', None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names.  A ``gpu`` context
        raises :class:`MXNetError` when no such CUDA device exists."""
        if self.device_type == 'cpu':
            return torch.device('cpu')
        if not torch.cuda.is_available():
            raise MXNetError(
                'context %s needs a CUDA device and none is available; '
                "ask for the CPU explicitly (dev_type='cpu' / ctx=cpu())"
                % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError('context %s: only %d CUDA device(s)'
                             % (self, torch.cuda.device_count()))
        return torch.device('cuda', self.device_id)


def cpu(device_id=0):
    """Return a CPU context."""
    return Context('cpu', device_id)


def gpu(device_id=0):
    """Return a CUDA GPU context."""
    return Context('gpu', device_id)


def current_context() -> Context:
    """The thread-local default context (``cpu(0)`` outside any ``with``
    scope)."""
    ctx = getattr(Context._default_ctx, 'value', None)
    return ctx if ctx is not None else Context('cpu', 0)


def compute_context() -> Context:
    """The context of an imperative op that makes an array from no input
    array and is given no ``ctx``: the ``with`` scope's, else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, 'value', None)
    return ctx if ctx is not None else Context('gpu', 0)


def context_of(device) -> Context:
    """The Context naming a ``torch.device`` (or a string such as
    ``'cuda:0'``)."""
    device = torch.device(device)
    if device.type == 'cuda':
        return Context('gpu', device.index if device.index is not None
                       else torch.cuda.current_device())
    if device.type == 'cpu':
        return Context('cpu', 0)
    raise MXNetError('no context for device %s' % device)


def as_torch_device(ctx):
    """The ``torch.device`` of ``ctx``: a Context, a ``torch.device``, a
    context string as symbol JSON stores it (``'gpu(0)'``) or None (the
    current context)."""
    if ctx is None:
        return current_context().torch_device
    if isinstance(ctx, Context):
        return ctx.torch_device
    if isinstance(ctx, torch.device):
        return ctx
    text = str(ctx).strip()
    if text.endswith(')') and '(' in text:
        kind, _, idx = text[:-1].partition('(')
        return Context(kind, int(idx)).torch_device
    return torch.device(text)
