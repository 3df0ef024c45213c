"""Device context.

The PyTorch counterpart of ``mxnet_tpu/context.py``.  A ``Context`` names
a logical device, ``cpu(i)`` or ``gpu(i)``, and resolves to a
``torch.device``.  A ``gpu`` context on a host without a CUDA device
raises when it is resolved: nothing in the port quietly runs a GPU
request on the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError


class Context:
    """A logical device, e.g. ``Context('gpu', 0)``."""

    devtype2str = {1: 'cpu', 2: 'gpu'}
    devstr2type = {'cpu': 1, 'gpu': 2}

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
