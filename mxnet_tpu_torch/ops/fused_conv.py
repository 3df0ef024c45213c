"""Fused BN-apply + relu + 3x3 convolution: ``fused_scale_bias_conv3x3``.

``fused_scale_bias_conv3x3(x, w, scale, bias) = conv3x3(relu(x * scale +
bias).astype(x.dtype), w)`` — the counterpart of
``mxnet_tpu/ops/pallas_conv.py`` (TPU kernel ``_pallas_conv``), the 3x3
case of the ``_bn_relu_conv`` node (fuse.py).  NHWC input, HWIO weights,
NHWC output, pad 1, stride 1 or 2, f32 accumulation; the zero padding
applies AFTER the affine and relu (a halo position contributes 0, not
``relu(bias)``).

On a CUDA tensor the wrapper launches the hand-written implicit-GEMM
kernel ``csrc/fused_scale_bias_conv3x3.cu`` (built and bound by
``ops/_kernels.py``) or raises; a CPU or ``meta`` tensor takes the plain
PyTorch version :func:`fused_scale_bias_conv3x3_plain`.  The backward is
the reference's ``_bwd`` (``pallas_conv.py:178-193``): the relu mask and
the affine pullback composed with the linear convolution's two
gradients, which come from ``torch.nn.grad`` (the reference takes them
from ``jax.vjp`` of the plain convolution, outside any kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from . import _kernels
from .fused import (_DTYPE_CODE, _check_dtype, _check_vec, _count,
                    _device_kind, _raise_launch)

__all__ = ['fused_scale_bias_conv3x3', 'fused_scale_bias_conv3x3_plain',
           'conv3x3_out_hw']

_NAME = 'fused_scale_bias_conv3x3'


def conv3x3_out_hw(h, w, stride):
    """Output height and width of a pad-1 3x3 convolution."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _prologue(x, scale, bias, relu):
    """The affine (and relu) in f32, rounded to x's dtype."""
    xa = x.float() * scale.float() + bias.float()
    if relu:
        xa = torch.relu(xa)
    return xa.to(x.dtype)


def fused_scale_bias_conv3x3_plain(x, w, scale, bias, stride=1, relu=True):
    """The plain version, with the kernel's arithmetic: the prologue
    rounded to x's dtype, then a float32 convolution of the rounded
    values (F.conv2d on NCHW/OIHW views), stored in x's dtype."""
    xa = _prologue(x, scale, bias, relu)
    y = F.conv2d(xa.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), None, stride, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _check(x, w, scale, bias, stride):
    _check_dtype(_NAME, x)
    if x.ndim != 4:
        raise ValueError('%s: x must be NHWC, got shape %s'
                         % (_NAME, tuple(x.shape)))
    c = x.shape[3]
    if not isinstance(w, torch.Tensor) or w.ndim != 4 or \
            tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError('%s: w must be HWIO (3, 3, %d, F)' % (_NAME, c))
    if w.dtype != x.dtype:
        raise TypeError('%s: w must be %s like x, got %s'
                        % (_NAME, x.dtype, w.dtype))
    if w.device != x.device:
        raise ValueError('%s: w is on %s, x on %s' % (_NAME, w.device,
                                                      x.device))
    if not w.is_contiguous():
        raise ValueError('%s: w must be contiguous' % _NAME)
    if stride not in (1, 2):
        raise ValueError('%s: stride must be 1 or 2, got %r'
                         % (_NAME, stride))
    _check_vec(_NAME, x, c, ('scale', scale), ('bias', bias))


def _launch(x, w, scale, bias, stride, relu):
    n, h, wd, c = x.shape
    f = w.shape[3]
    oh, ow = conv3x3_out_hw(h, wd, stride)
    y = torch.empty((n, oh, ow, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    s = scale.float().contiguous()
    b = bias.float().contiguous()
    fn = _kernels.load(_NAME)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
                 y.data_ptr(), n, h, wd, c, f, oh, ow, stride,
                 int(bool(relu)), _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch(_NAME, err)
    _count(fused_scale_bias_conv3x3)
    return y


def _bwd(x, w, scale, bias, g, stride, relu):
    """The reference's ``_bwd`` (``pallas_conv.py:178-193``)."""
    x32 = x.float()
    pre = x32 * scale.float() + bias.float()
    xa = (torch.relu(pre) if relu else pre).to(x.dtype)
    xa_nchw = xa.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1)
    g_nchw = g.to(x.dtype).permute(0, 3, 1, 2)
    dxa = nn_grad.conv2d_input(xa_nchw.shape, w_oihw, g_nchw, stride, 1)
    dw = nn_grad.conv2d_weight(xa_nchw, w_oihw.shape, g_nchw, stride, 1)
    dxa = dxa.permute(0, 2, 3, 1).float()
    if relu:
        dxa = dxa * (pre > 0)
    dx = (dxa * scale.float()).to(x.dtype)
    dscale = torch.sum(dxa * x32, dim=(0, 1, 2)).to(scale.dtype)
    dbias = torch.sum(dxa, dim=(0, 1, 2)).to(bias.dtype)
    return dx, dw.permute(2, 3, 1, 0).to(w.dtype), dscale, dbias


class _ScaleBiasConvFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, scale, bias, stride, relu):
        ctx.save_for_backward(x, w, scale, bias)
        ctx.stride, ctx.relu = stride, relu
        if x.device.type == 'cuda':
            return _launch(x, w, scale, bias, stride, relu)
        return fused_scale_bias_conv3x3_plain(x, w, scale, bias, stride,
                                              relu)

    @staticmethod
    def backward(ctx, g):
        return _bwd(*ctx.saved_tensors, g, ctx.stride, ctx.relu) \
            + (None, None)


def fused_scale_bias_conv3x3(x, w, scale, bias, stride=1, relu=True):
    """``conv3x3(relu(x * scale + bias), w)``, pad 1, stride 1 or 2: the
    affine (and relu) in f32 rounded to x's dtype, zero padding after
    it, f32 accumulation, stored in x's dtype.  x is a contiguous NHWC
    float32 or bfloat16 tensor, w a contiguous HWIO (3, 3, C, F) tensor
    of x's dtype, scale and bias 1-D of length C.  A CUDA tensor runs the
    kernel (``fused_scale_bias_conv3x3.launches``), a CPU tensor the
    plain version."""
    stride = int(stride)
    _check(x, w, scale, bias, stride)
    _device_kind(_NAME, x)
    return _ScaleBiasConvFn.apply(x, w, scale, bias, stride, bool(relu))


fused_scale_bias_conv3x3.launches = 0
