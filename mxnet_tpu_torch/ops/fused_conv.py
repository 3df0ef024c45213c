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
PyTorch version :func:`fused_scale_bias_conv3x3_plain`.  The kernel has
three routes, chosen by :func:`conv3x3_route` before the launch and
counted in ``fused_scale_bias_conv3x3.launches_by_route``: ``sm90``
(bfloat16 with C a multiple of 64: the TMA + wgmma pipeline of
``csrc/hopper_gemm.cuh``, A loaded by TMA's im2col mode, B the (F, 9C)
weight of :func:`conv3x3_weight_fk`), ``wmma`` (the other bfloat16
shapes) and ``simt`` (float32), the last two on the HWIO weight.  The
weight may be given as a contiguous HWIO tensor or as the HWIO view of a
contiguous OIHW weight (as the fuse pass passes it); a launch makes at
most one copy of it, in the layout its route reads.  The backward is
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
from .fused import (_DTYPE_CODE, ROUTES, _check_dtype, _check_vec, _count,
                    _device_kind, _flops, _raise_launch, _sm90_plan,
                    _sm_count)

__all__ = ['fused_scale_bias_conv3x3', 'fused_scale_bias_conv3x3_plain',
           'conv3x3_out_hw', 'conv3x3_route', 'conv_route',
           'conv3x3_weight_fk']

_NAME = 'fused_scale_bias_conv3x3'


def conv3x3_out_hw(h, w, stride):
    """Output height and width of a pad-1 3x3 convolution."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def conv3x3_route(dtype, c, f, ptrs):
    """The route of one conv kernel call: ``'simt'`` for float32; for
    bfloat16 ``'sm90'`` when C is a multiple of 64 (every 64-deep K step
    of the tap-major implicit GEMM lies inside one tap, and one im2col
    box), F a multiple of 8 and every base address in ``ptrs`` (X, the
    (F, 9C) weight, Y) 16-byte aligned, else ``'wmma'``.  A pure function
    of dtype, shape and alignment, decided before the launch."""
    if dtype == torch.float32:
        return 'simt'
    if dtype != torch.bfloat16:
        raise TypeError('no conv3x3 route for %s' % dtype)
    if c % 64 or f % 8 or any(p % 16 for p in ptrs):
        return 'wmma'
    return 'sm90'


def conv3x3_weight_fk(w):
    """The HWIO (3, 3, C, F) weight as the sm90 route's B operand: the
    (F, 9C) K-major matrix, K tap-major (k = (3 dy + dx) C + c), i.e. the
    OIHW weight as OHWI.  A copy unless ``w`` is the HWIO view of an
    OHWI-contiguous tensor."""
    f = w.shape[3]
    return w.permute(3, 0, 1, 2).contiguous().reshape(f, -1)


def conv_route(x, w):
    """The route :func:`fused_scale_bias_conv3x3` takes for ``x`` and
    ``w`` on the card (:func:`conv3x3_route`): the kernel reads the
    weight where its OHWI view already lies contiguous, else in the
    aligned copy :func:`conv3x3_weight_fk` makes (address 0 here); Y is a
    fresh, aligned tensor."""
    ohwi = w.permute(3, 0, 1, 2)
    return conv3x3_route(x.dtype, x.shape[3], w.shape[3],
                         (x.data_ptr(),
                          ohwi.data_ptr() if ohwi.is_contiguous() else 0))


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


def fused_scale_bias_conv3x3_flops(x, w, stride=1):
    """The FLOPs of one launch as FlopCounterMode counts the plain
    version's convolution: 2·N·OH·OW·F·C·9."""
    n, h, wd, c = x.shape
    oh, ow = conv3x3_out_hw(h, wd, stride)
    return 2 * n * oh * ow * w.shape[3] * c * 9


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
    if not (w.is_contiguous() or w.permute(3, 2, 0, 1).is_contiguous()):
        raise ValueError('%s: w must be contiguous HWIO, or the HWIO view '
                         'of a contiguous OIHW weight' % _NAME)
    if stride not in (1, 2):
        raise ValueError('%s: stride must be 1 or 2, got %r'
                         % (_NAME, stride))
    _check_vec(_NAME, x, c, ('scale', scale), ('bias', bias))


def _launch(x, w, scale, bias, stride, relu, route=None):
    """Launch the kernel on ``route`` (default: :func:`conv_route`'s)."""
    n, h, wd, c = x.shape
    f = w.shape[3]
    oh, ow = conv3x3_out_hw(h, wd, stride)
    route = route or conv_route(x, w)
    y = torch.empty((n, oh, ow, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    s = scale.float().contiguous()
    b = bias.float().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == 'sm90':
            wfk = conv3x3_weight_fk(w)
            # the prologue reads scale and bias 16 bytes at a time
            s, b = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (s, b))
            bn, stages, grid = _sm90_plan(n * oh * ow, f, _sm_count(x.device))
            err = _kernels.load(_NAME, 'mxtpu_fused_scale_bias_conv3x3_sm90')(
                x.data_ptr(), wfk.data_ptr(), s.data_ptr(), b.data_ptr(),
                y.data_ptr(), n, h, wd, c, f, oh, ow, stride,
                int(bool(relu)), bn, stages, grid, stream)
        else:
            whwio = w.contiguous()
            err = _kernels.load(_NAME)(
                x.data_ptr(), whwio.data_ptr(), s.data_ptr(), b.data_ptr(),
                y.data_ptr(), n, h, wd, c, f, oh, ow, stride,
                int(bool(relu)), _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch(_NAME, err)
    _count(fused_scale_bias_conv3x3, route)
    _flops(fused_scale_bias_conv3x3_flops(x, w, stride))
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
    float32 or bfloat16 tensor, w an HWIO (3, 3, C, F) tensor of x's
    dtype, contiguous or the HWIO view of a contiguous OIHW weight, scale
    and bias 1-D of length C.  A CUDA tensor runs the kernel on
    :func:`conv_route`'s route (``fused_scale_bias_conv3x3.launches``,
    ``.launches_by_route``), a CPU tensor the plain version."""
    stride = int(stride)
    _check(x, w, scale, bias, stride)
    _device_kind(_NAME, x)
    return _ScaleBiasConvFn.apply(x, w, scale, bias, stride, bool(relu))


fused_scale_bias_conv3x3.launches = 0
fused_scale_bias_conv3x3.launches_by_route = dict.fromkeys(ROUTES, 0)
