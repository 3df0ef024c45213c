"""Fused BN-ReLU: ``relu(x * scale + bias)`` with a per-channel affine.

The counterpart of ``fused_bn_relu`` in ``mxnet_tpu/ops/pallas_fused.py``
(TPU kernel ``_bn_relu_pallas``), the one kernel on the ResNet serving
path: the ``bn_relu`` pass (fuse.py) lowers every BatchNorm->relu chain
left after conv+BN folding onto it.  On a CUDA tensor the wrapper
launches the hand-written kernel ``csrc/fused_bn_relu.cu`` (built and
bound by ``ops/_kernels.py``) or raises; a CPU tensor takes the plain
PyTorch version, :func:`fused_bn_relu_plain`, which the tests and
``chip_smoke.py`` hold the kernel against.  A ``meta`` tensor (shape
inference) also takes the plain version, which computes no values.
"""
from __future__ import annotations

import math
import threading

import torch

from ..base import MXNetError
from . import _kernels
from .registry import register_simple

__all__ = ['fused_bn_relu', 'fused_bn_relu_plain']

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def fused_bn_relu_plain(x, scale, bias):
    """The plain version: the affine in f32, relu, cast to x's dtype.
    Channel = axis 1 (the trailing axis of a 2-D input)."""
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    y = x.float() * scale.float().reshape(bshape) \
        + bias.float().reshape(bshape)
    return torch.relu(y).to(x.dtype)


def _check(x, scale, bias):
    if not isinstance(x, torch.Tensor):
        raise TypeError('fused_bn_relu: x must be a torch.Tensor, got %s'
                        % type(x).__name__)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError('fused_bn_relu: x must be float32 or bfloat16, '
                        'got %s' % x.dtype)
    if x.ndim < 2:
        raise ValueError('fused_bn_relu: x must be (M, C) or (N, C, ...), '
                         'got shape %s' % (tuple(x.shape),))
    if not x.is_contiguous():
        raise ValueError('fused_bn_relu: x must be contiguous')
    c = x.shape[1]
    for nm, v in (('scale', scale), ('bias', bias)):
        if not isinstance(v, torch.Tensor) or v.ndim != 1 or \
                v.shape[0] != c:
            raise ValueError('fused_bn_relu: %s must be a 1-D tensor of '
                             'length C=%d' % (nm, c))
        if v.dtype not in (torch.float32, x.dtype):
            raise TypeError('fused_bn_relu: %s must be float32 or %s, got '
                            '%s' % (nm, x.dtype, v.dtype))
        if v.device != x.device:
            raise ValueError('fused_bn_relu: %s is on %s, x on %s'
                             % (nm, v.device, x.device))


def _launch(x, scale, bias):
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    hw = math.prod(x.shape[2:])
    s = scale.float().contiguous()
    b = bias.float().contiguous()
    fn = _kernels.load('fused_bn_relu')
    vec_ok = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(),
                 n, hw, x.shape[1], _DTYPE_CODE[x.dtype], int(vec_ok),
                 stream)
    if err:
        raise MXNetError('fused_bn_relu: kernel launch failed: %s (CUDA '
                         'error %d)'
                         % (_kernels.error_string('fused_bn_relu', err), err))
    with _count_lock:
        fused_bn_relu.launches += 1
    return y


def fused_bn_relu(x, scale, bias):
    """``relu(x * scale[c] + bias[c])`` computed in f32 and stored in x's
    dtype; channel = axis 1 (the trailing axis of a 2-D input).  x is a
    contiguous float32 or bfloat16 tensor; scale and bias are 1-D of
    length C, float32 or x's dtype, on x's device.  A CUDA tensor runs
    the kernel (``fused_bn_relu.launches`` counts its launches) and a
    CPU tensor the plain version."""
    _check(x, scale, bias)
    dev = x.device.type
    if dev == 'cuda':
        return _launch(x, scale, bias)
    if dev in ('cpu', 'meta'):
        return fused_bn_relu_plain(x, scale, bias)
    raise MXNetError('fused_bn_relu: unsupported device %s' % x.device)


fused_bn_relu.launches = 0


register_simple('fused_bn_relu', fused_bn_relu, ninputs=3,
                input_names=['data', 'scale', 'bias'])
