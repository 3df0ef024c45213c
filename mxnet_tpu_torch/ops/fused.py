"""Fused GEMM prologue/epilogue kernels: ``fused_bn_relu``,
``fused_scale_bias_dot`` and ``fused_dot_epilogue``.

The counterparts of ``mxnet_tpu/ops/pallas_fused.py``:

- ``fused_bn_relu(x, scale, bias) = relu(x * scale[c] + bias[c])`` (TPU
  kernel ``_bn_relu_pallas``): the ``bn_relu`` pass (fuse.py) lowers
  every BatchNorm->relu chain that feeds no fusable conv onto it.
- ``fused_scale_bias_dot(x, w, scale, bias) = (relu?)(x * scale + bias)
  @ w`` (TPU kernel ``_pallas_forward``): the 1x1-convolution case of the
  ``_bn_relu_conv`` node (fuse.py), the BatchNorm apply step fused into
  the matmul that consumes it.
- ``fused_dot_epilogue(x, w, bias, relu, clip) = clip?(relu?(x @ w +
  bias))`` (TPU kernel ``_dot_epi_pallas``): the aggressive lowering of
  the ``epilogue`` pass (fuse.py), a FullyConnected whose bias-add, relu
  and clip run on the f32 accumulator before the one store.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_bn_relu.cu``, ``csrc/fused_scale_bias_dot.cu``,
``csrc/fused_dot_epilogue.cu``, built and bound by ``ops/_kernels.py``)
or raises; a CPU tensor takes the plain PyTorch version (``*_plain``),
which the tests and ``chip_smoke.py`` hold the kernel against.  A
``meta`` tensor (shape inference) also takes the plain version, which
computes no values.  Each kernel's ``launches`` counter counts its
launches.

All are ``torch.autograd.Function``s whose backward is the reference's
``custom_vjp`` backward (``_bn_relu_bwd``, ``_bwd``, ``_dot_epi_bwd``),
which the JAX package computes in plain JAX outside any kernel; here it
is plain PyTorch (the matmuls of the backwards go to ``torch.matmul``).
"""
from __future__ import annotations

import math
import threading

import torch

from ..base import MXNetError
from . import _kernels
from .registry import register_simple

__all__ = ['fused_bn_relu', 'fused_bn_relu_plain', 'fused_scale_bias_dot',
           'fused_scale_bias_dot_plain', 'fused_dot_epilogue',
           'fused_dot_epilogue_plain']

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _count(fn):
    with _count_lock:
        fn.launches += 1


def _raise_launch(name, err):
    raise MXNetError('%s: kernel launch failed: %s (CUDA error %d)'
                     % (name, _kernels.error_string(name, err), err))


def _check_dtype(name, x):
    if not isinstance(x, torch.Tensor):
        raise TypeError('%s: x must be a torch.Tensor, got %s'
                        % (name, type(x).__name__))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError('%s: x must be float32 or bfloat16, got %s'
                        % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError('%s: x must be contiguous' % name)


def _check_vec(name, x, c, *vecs):
    """``vecs`` are (name, tensor) pairs: 1-D of length ``c``, float32
    or x's dtype, on x's device."""
    for nm, v in vecs:
        if not isinstance(v, torch.Tensor) or v.ndim != 1 or \
                v.shape[0] != c:
            raise ValueError('%s: %s must be a 1-D tensor of length %d'
                             % (name, nm, c))
        if v.dtype not in (torch.float32, x.dtype):
            raise TypeError('%s: %s must be float32 or %s, got %s'
                            % (name, nm, x.dtype, v.dtype))
        if v.device != x.device:
            raise ValueError('%s: %s is on %s, x on %s'
                             % (name, nm, v.device, x.device))


def _device_kind(name, x):
    dev = x.device.type
    if dev not in ('cuda', 'cpu', 'meta'):
        raise MXNetError('%s: unsupported device %s' % (name, x.device))
    return dev


# ---------------------------------------------------------------------------
# fused_bn_relu
# ---------------------------------------------------------------------------

def fused_bn_relu_plain(x, scale, bias):
    """The plain version: the affine in f32, relu, cast to x's dtype.
    Channel = axis 1 (the trailing axis of a 2-D input)."""
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    y = x.float() * scale.float().reshape(bshape) \
        + bias.float().reshape(bshape)
    return torch.relu(y).to(x.dtype)


def _bn_relu_check(x, scale, bias):
    _check_dtype('fused_bn_relu', x)
    if x.ndim < 2:
        raise ValueError('fused_bn_relu: x must be (M, C) or (N, C, ...), '
                         'got shape %s' % (tuple(x.shape),))
    _check_vec('fused_bn_relu', x, x.shape[1], ('scale', scale),
               ('bias', bias))


def _bn_relu_launch(x, scale, bias):
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
        _raise_launch('fused_bn_relu', err)
    _count(fused_bn_relu)
    return y


def _bn_relu_bwd(x, scale, bias, g):
    """The reference's ``_bn_relu_bwd`` (``pallas_fused.py:256-267``)."""
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    axes = (0,) + tuple(range(2, x.ndim))
    x32 = x.float()
    s32 = scale.float().reshape(bshape)
    pre = x32 * s32 + bias.float().reshape(bshape)
    gm = g.float() * (pre > 0)
    dx = (gm * s32).to(x.dtype)
    dscale = torch.sum(gm * x32, dim=axes).to(scale.dtype)
    dbias = torch.sum(gm, dim=axes).to(bias.dtype)
    return dx, dscale, dbias


class _BNReluFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale, bias)
        if x.device.type == 'cuda':
            return _bn_relu_launch(x, scale, bias)
        return fused_bn_relu_plain(x, scale, bias)

    @staticmethod
    def backward(ctx, g):
        return _bn_relu_bwd(*ctx.saved_tensors, g)


def fused_bn_relu(x, scale, bias):
    """``relu(x * scale[c] + bias[c])`` computed in f32 and stored in x's
    dtype; channel = axis 1 (the trailing axis of a 2-D input).  x is a
    contiguous float32 or bfloat16 tensor; scale and bias are 1-D of
    length C, float32 or x's dtype, on x's device.  A CUDA tensor runs
    the kernel (``fused_bn_relu.launches`` counts its launches) and a
    CPU tensor the plain version."""
    _bn_relu_check(x, scale, bias)
    _device_kind('fused_bn_relu', x)
    return _BNReluFn.apply(x, scale, bias)


fused_bn_relu.launches = 0


# ---------------------------------------------------------------------------
# fused_scale_bias_dot
# ---------------------------------------------------------------------------

def fused_scale_bias_dot_plain(x, w, scale, bias, relu=False):
    """The plain version, with the kernel's arithmetic: the affine (and
    relu) in f32, rounded to x's dtype, then the product with f32
    accumulation, stored in x's dtype."""
    xa = x.float() * scale.float() + bias.float()
    if relu:
        xa = torch.relu(xa)
    xa = xa.to(x.dtype)
    return torch.matmul(xa.float(), w.float()).to(x.dtype)


def _dot_check(x, w, scale, bias):
    name = 'fused_scale_bias_dot'
    _check_dtype(name, x)
    if x.ndim != 2:
        raise ValueError('%s: x must be 2-D (M, K), got shape %s'
                         % (name, tuple(x.shape)))
    if not isinstance(w, torch.Tensor) or w.ndim != 2 or \
            w.shape[0] != x.shape[1]:
        raise ValueError('%s: w must be (K, N) with K=%d' % (name,
                                                            x.shape[1]))
    if w.dtype != x.dtype:
        raise TypeError('%s: w must be %s like x, got %s'
                        % (name, x.dtype, w.dtype))
    if w.device != x.device:
        raise ValueError('%s: w is on %s, x on %s' % (name, w.device,
                                                      x.device))
    if not w.is_contiguous():
        raise ValueError('%s: w must be contiguous' % name)
    _check_vec(name, x, x.shape[1], ('scale', scale), ('bias', bias))


def _dot_launch(x, w, scale, bias, relu):
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    s = scale.float().contiguous()
    b = bias.float().contiguous()
    fn = _kernels.load('fused_scale_bias_dot')
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
                 y.data_ptr(), m, n, k, int(bool(relu)),
                 _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch('fused_scale_bias_dot', err)
    _count(fused_scale_bias_dot)
    return y


def _dot_bwd(x, w, scale, bias, g, relu):
    """The reference's ``_bwd`` (``pallas_fused.py:145-160``)."""
    g32 = g.float()
    gx = torch.matmul(g32, w.float().t())    # d(loss)/d(xa) pre-matmul
    xa = x.float() * scale.float() + bias.float()
    if relu:
        dw_lhs = torch.relu(xa)
        gx = gx * (xa > 0)
    else:
        dw_lhs = xa
    dx = (gx * scale.float()).to(x.dtype)
    dw = torch.matmul(dw_lhs.t(), g32).to(w.dtype)
    dscale = torch.sum(gx * x.float(), dim=0).to(scale.dtype)
    dbias = torch.sum(gx, dim=0).to(bias.dtype)
    return dx, dw, dscale, dbias


class _ScaleBiasDotFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu):
        ctx.save_for_backward(x, w, scale, bias)
        ctx.relu = relu
        if x.device.type == 'cuda':
            return _dot_launch(x, w, scale, bias, relu)
        return fused_scale_bias_dot_plain(x, w, scale, bias, relu)

    @staticmethod
    def backward(ctx, g):
        return _dot_bwd(*ctx.saved_tensors, g, ctx.relu) + (None,)


def fused_scale_bias_dot(x, w, scale, bias, relu=False):
    """``(relu?)(x * scale + bias) @ w``: the per-K-column affine (and
    relu) in f32, rounded to x's dtype, then the product accumulated in
    f32 and stored in x's dtype.  x is a contiguous (M, K) float32 or
    bfloat16 tensor, w a contiguous (K, N) tensor of x's dtype, scale
    and bias 1-D of length K (float32 or x's dtype).  A CUDA tensor runs
    the kernel (``fused_scale_bias_dot.launches``), a CPU tensor the
    plain version."""
    _dot_check(x, w, scale, bias)
    _device_kind('fused_scale_bias_dot', x)
    return _ScaleBiasDotFn.apply(x, w, scale, bias, bool(relu))


fused_scale_bias_dot.launches = 0


# ---------------------------------------------------------------------------
# fused_dot_epilogue
# ---------------------------------------------------------------------------

def fused_dot_epilogue_plain(x, w, bias=None, relu=False, clip=None):
    """The plain version, with the kernel's arithmetic: the product in
    f32, bias add, relu and clip on the f32 result (NaN propagates, as
    jnp.maximum / jnp.clip do), one rounding to x's dtype.  (The
    reference's ``_dot_epi_reference`` rounds ``x @ w`` to x's dtype
    before the bias add; the two agree in f32.)"""
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    if clip is not None:
        y = torch.clamp(y, clip[0], clip[1])
    return y.to(x.dtype)


def _epi_check(x, w, bias):
    name = 'fused_dot_epilogue'
    _check_dtype(name, x)
    if x.ndim != 2:
        raise ValueError('%s: x must be 2-D (M, K), got shape %s'
                         % (name, tuple(x.shape)))
    if not isinstance(w, torch.Tensor) or w.ndim != 2 or \
            w.shape[0] != x.shape[1]:
        raise ValueError('%s: w must be (K, N) with K=%d' % (name,
                                                            x.shape[1]))
    if w.dtype != x.dtype:
        raise TypeError('%s: w must be %s like x, got %s'
                        % (name, x.dtype, w.dtype))
    if w.device != x.device:
        raise ValueError('%s: w is on %s, x on %s' % (name, w.device,
                                                      x.device))
    if bias is not None:
        _check_vec(name, x, w.shape[1], ('bias', bias))


def _epi_launch(x, w, bias, relu, clip):
    m, k = x.shape
    n = w.shape[1]
    # the kernel reads W as the FullyConnected weight lies, (N, K): free
    # when w is the transposed view of such a weight
    wt = w.t().contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    b = None if bias is None else bias.float().contiguous()
    lo, hi = clip if clip is not None else (0.0, 0.0)
    fn = _kernels.load('fused_dot_epilogue')
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wt.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(), m, n, k,
                 int(bool(relu)), int(clip is not None), float(lo),
                 float(hi), _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch('fused_dot_epilogue', err)
    _count(fused_dot_epilogue)
    return y


def _dot_epi_bwd(x, w, bias, g, relu, clip):
    """The reference's ``_dot_epi_bwd`` (``pallas_fused.py:376-389``)."""
    x32, w32 = x.float(), w.float()
    pre = torch.matmul(x32, w32)
    if bias is not None:
        pre = pre + bias.float()
    z = torch.relu(pre) if relu else pre
    gm = g.float()
    if clip is not None:
        gm = gm * ((z > clip[0]) & (z < clip[1]))
    if relu:
        gm = gm * (pre > 0)
    dx = torch.matmul(gm, w32.t()).to(x.dtype)
    dw = torch.matmul(x32.t(), gm).to(w.dtype)
    dbias = None if bias is None else torch.sum(gm, dim=0).to(bias.dtype)
    return dx, dw, dbias


class _DotEpilogueFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, relu, clip):
        ctx.save_for_backward(x, w, bias)
        ctx.relu, ctx.clip = relu, clip
        if x.device.type == 'cuda':
            return _epi_launch(x, w, bias, relu, clip)
        return fused_dot_epilogue_plain(x, w, bias, relu, clip)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        return _dot_epi_bwd(x, w, bias, g, ctx.relu, ctx.clip) + (None, None)


def fused_dot_epilogue(x, w, bias=None, relu=False, clip=None):
    """``(x @ w) [+ bias] [-> relu] [-> clip(lo, hi)]`` with the epilogue
    applied to the f32 accumulator and one rounding to x's dtype.  x is
    a contiguous (M, K) float32 or bfloat16 tensor, w a (K, N) tensor of
    x's dtype (the transposed view of an (N, K) FullyConnected weight is
    read as it lies), bias None or 1-D of length N (float32 or x's
    dtype), ``clip`` a (lo, hi) pair or None.  A CUDA tensor runs the
    kernel (``fused_dot_epilogue.launches``), a CPU tensor the plain
    version."""
    if clip is not None:
        if len(clip) != 2:
            raise ValueError('fused_dot_epilogue: clip must be a (lo, hi) '
                             'pair, got %r' % (clip,))
        clip = (float(clip[0]), float(clip[1]))
    _epi_check(x, w, bias)
    _device_kind('fused_dot_epilogue', x)
    return _DotEpilogueFn.apply(x, w, bias, bool(relu), clip)


fused_dot_epilogue.launches = 0


register_simple('fused_bn_relu', fused_bn_relu, ninputs=3,
                input_names=['data', 'scale', 'bias'])
register_simple('fused_scale_bias_dot', fused_scale_bias_dot, ninputs=4,
                input_names=['data', 'weight', 'scale', 'bias'],
                attr_defaults={'relu': False})
register_simple('fused_dot_epilogue', fused_dot_epilogue, ninputs=3,
                input_names=['data', 'weight', 'bias'],
                attr_defaults={'relu': False, 'clip': None})
