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

The two GEMM kernels have three routes each, chosen by
:func:`gemm_route` from dtype, shape and alignment before the launch
(never because another route failed) and counted in the wrapper's
``launches_by_route``: ``sm90``, the warp-specialised TMA + wgmma
pipeline of ``csrc/hopper_gemm.cuh`` (bfloat16, K and N multiples of 8,
16-byte aligned bases: every shape of the training paths), planned per
shape by :func:`_sm90_plan`; ``wmma``, the first WMMA design, for the
other bfloat16 shapes; ``simt`` for float32.

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
           'fused_dot_epilogue_plain', 'gemm_route', 'dot_route',
           'epilogue_route', 'ROUTES']

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _count(fn, route=None):
    with _count_lock:
        fn.launches += 1
        if route is not None:
            fn.launches_by_route[route] += 1


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
# GEMM routes and the sm90 tile plan
# ---------------------------------------------------------------------------

ROUTES = ('sm90', 'wmma', 'simt')
# csrc/hopper_gemm.cuh: 128-row tiles, 64-deep K stages, 16 bytes of
# mbarriers per stage, two 64 x 72 bf16 epilogue staging tiles, 1024
# bytes of alignment slack; a block may use 227 KB
_SM90_BM, _SM90_BK = 128, 64
_SM90_WIDTHS = (256, 128, 64)
_SM90_MAX_STAGES = 8
_SM90_EPI_BYTES = 2 * 64 * 72 * 2
SM90_SMEM_LIMIT = 232448
_sm_counts = {}


def gemm_route(dtype, k, n, ptrs):
    """The route of one GEMM kernel call: ``'simt'`` for float32; for
    bfloat16 ``'sm90'`` when K and N are multiples of 8 and every base
    address in ``ptrs`` (X, W as the kernel reads it, Y) is 16-byte
    aligned -- TMA's row-stride and address rules and the epilogue's
    16-byte stores -- else ``'wmma'``.  A pure function of dtype, shape
    and alignment, decided before the launch."""
    if dtype == torch.float32:
        return 'simt'
    if dtype != torch.bfloat16:
        raise TypeError('no GEMM route for %s' % dtype)
    if k % 8 or n % 8 or any(p % 16 for p in ptrs):
        return 'wmma'
    return 'sm90'


def _sm90_smem(bn, stages):
    """Dynamic shared memory of one sm90 block, in bytes
    (``smem_bytes`` of ``csrc/hopper_gemm.cuh``)."""
    return 1024 + stages * ((_SM90_BM + bn) * _SM90_BK * 2 + 16) \
        + _SM90_EPI_BYTES


def _sm90_plan(m, n, sms):
    """``(bn, stages, grid)`` of an sm90 launch with M rows and N columns
    on a card of ``sms`` SMs.  ``bn``: the widest tile (256, 128, 64) no
    wider than N rounded up to 64 that still gives about a wave of
    128-row tiles (7/10 of the SMs), else the narrowest: a K step costs
    nearly the same at every width, so wider tiles win until they leave
    SMs idle (``tools/torch_gemm_sweep.py`` times every width at the path
    shapes); ``stages``: as many as the shared memory holds beside the
    epilogue's staging, at most 8; ``grid``: one persistent block per SM,
    at most one per tile."""
    rows = -(-m // _SM90_BM)
    widths = [b for b in _SM90_WIDTHS if b <= -(-n // 64) * 64]
    bn = next((b for b in widths if 10 * rows * -(-n // b) >= 7 * sms),
              widths[-1])
    return bn, _sm90_stages(bn), min(rows * -(-n // bn), sms)


def _sm90_stages(bn):
    """Stages of tile width ``bn``: as many as the shared memory holds
    beside the epilogue's staging, at most 8."""
    per_stage = _sm90_smem(bn, 1) - _sm90_smem(bn, 0)
    return min(_SM90_MAX_STAGES,
               (SM90_SMEM_LIMIT - _sm90_smem(bn, 0)) // per_stage)


def _wnk_route(x, w):
    """:func:`gemm_route` of a checked GEMM call whose kernel reads W as
    the (N, K) matrix ``w`` is a transposed view of, or as an aligned copy
    of ``w``; Y is a fresh, aligned tensor."""
    wnk = w.t()
    return gemm_route(x.dtype, x.shape[1], w.shape[1],
                      (x.data_ptr(),
                       wnk.data_ptr() if wnk.is_contiguous() else 0))


def _sm_count(device):
    """The SM count of a CUDA device, read once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


# ---------------------------------------------------------------------------
# fused_scale_bias_dot
# ---------------------------------------------------------------------------

def fused_scale_bias_dot_plain(x, w, scale, bias, relu=False):
    """The plain version, with the kernel's arithmetic: the affine (and
    relu) in f32, rounded to x's dtype, then the product with f32
    accumulation, stored in x's dtype.  ``w`` is read as a contiguous
    (K, N) matrix whatever its strides, so a transposed view gives the
    same bits as its contiguous copy."""
    xa = x.float() * scale.float() + bias.float()
    if relu:
        xa = torch.relu(xa)
    xa = xa.to(x.dtype)
    return torch.matmul(xa.float(), w.float().contiguous()).to(x.dtype)


def _dot_check(x, w, scale=None, bias=None):
    """scale and bias None: check x and w only."""
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
    if not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError('%s: w must be contiguous, or the transposed view '
                         'of a contiguous (N, K) weight' % name)
    if scale is not None or bias is not None:
        _check_vec(name, x, x.shape[1], ('scale', scale), ('bias', bias))


def dot_route(x, w):
    """The route :func:`fused_scale_bias_dot` takes for ``x`` and ``w``
    on the card (:func:`gemm_route`): the sm90 kernel reads W as the
    (N, K) weight ``w`` is a view of, or an aligned copy."""
    _dot_check(x, w)
    return _wnk_route(x, w)


def _dot_launch(x, w, scale, bias, relu, route=None):
    """Launch the kernel on ``route`` (default: :func:`dot_route`'s)."""
    m, k = x.shape
    n = w.shape[1]
    route = route or _wnk_route(x, w)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    s = scale.float().contiguous()
    b = bias.float().contiguous()
    name = 'fused_scale_bias_dot'
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == 'sm90':
            wnk = w.t().contiguous()    # no copy for a transposed view
            # the prologue reads scale and bias 16 bytes at a time
            s, b = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (s, b))
            bn, stages, grid = _sm90_plan(m, n, _sm_count(x.device))
            err = _kernels.load(name, 'mxtpu_fused_scale_bias_dot_sm90')(
                x.data_ptr(), wnk.data_ptr(), s.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, n, k, int(bool(relu)), bn, stages, grid,
                stream)
        else:
            wkn = w.contiguous()
            err = _kernels.load(name)(
                x.data_ptr(), wkn.data_ptr(), s.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, n, k, int(bool(relu)),
                _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch(name, err)
    _count(fused_scale_bias_dot, route)
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
    bfloat16 tensor, w a (K, N) tensor of x's dtype, contiguous or the
    transposed view of a contiguous (N, K) 1x1 weight (read as it lies
    on the sm90 route), scale and bias 1-D of length K (float32 or x's
    dtype).  A CUDA tensor runs the kernel on :func:`dot_route`'s route
    (``fused_scale_bias_dot.launches``, ``.launches_by_route``), a CPU
    tensor the plain version."""
    _dot_check(x, w, scale, bias)
    _device_kind('fused_scale_bias_dot', x)
    return _ScaleBiasDotFn.apply(x, w, scale, bias, bool(relu))


fused_scale_bias_dot.launches = 0
fused_scale_bias_dot.launches_by_route = dict.fromkeys(ROUTES, 0)


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


def epilogue_route(x, w):
    """The route :func:`fused_dot_epilogue` takes for ``x`` and ``w`` on
    the card (:func:`gemm_route`): every route reads W as the (N, K)
    FullyConnected weight ``w`` is a view of, or an aligned copy."""
    _epi_check(x, w, None)
    return _wnk_route(x, w)


def _epi_launch(x, w, bias, relu, clip, route=None):
    """Launch the kernel on ``route`` (default: :func:`epilogue_route`'s)."""
    m, k = x.shape
    n = w.shape[1]
    route = route or _wnk_route(x, w)
    # the kernel reads W as the FullyConnected weight lies, (N, K): free
    # when w is the transposed view of such a weight
    wt = w.t().contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    b = None if bias is None else bias.float().contiguous()
    lo, hi = clip if clip is not None else (0.0, 0.0)
    name = 'fused_dot_epilogue'
    args = (x.data_ptr(), wt.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), m, n, k, int(bool(relu)), int(clip is not None),
            float(lo), float(hi))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == 'sm90':
            bn, stages, grid = _sm90_plan(m, n, _sm_count(x.device))
            err = _kernels.load(name, 'mxtpu_fused_dot_epilogue_sm90')(
                *args, bn, stages, grid, stream)
        else:
            err = _kernels.load(name)(*args, _DTYPE_CODE[x.dtype], stream)
    if err:
        _raise_launch(name, err)
    _count(fused_dot_epilogue, route)
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
    kernel on :func:`epilogue_route`'s route
    (``fused_dot_epilogue.launches``, ``.launches_by_route``), a CPU
    tensor the plain version."""
    if clip is not None:
        if len(clip) != 2:
            raise ValueError('fused_dot_epilogue: clip must be a (lo, hi) '
                             'pair, got %r' % (clip,))
        clip = (float(clip[0]), float(clip[1]))
    _epi_check(x, w, bias)
    _device_kind('fused_dot_epilogue', x)
    return _DotEpilogueFn.apply(x, w, bias, bool(relu), clip)


fused_dot_epilogue.launches = 0
fused_dot_epilogue.launches_by_route = dict.fromkeys(ROUTES, 0)


register_simple('fused_bn_relu', fused_bn_relu, ninputs=3,
                input_names=['data', 'scale', 'bias'])
register_simple('fused_scale_bias_dot', fused_scale_bias_dot, ninputs=4,
                input_names=['data', 'weight', 'scale', 'bias'],
                attr_defaults={'relu': False})
register_simple('fused_dot_epilogue', fused_dot_epilogue, ninputs=3,
                input_names=['data', 'weight', 'bias'],
                attr_defaults={'relu': False, 'clip': None})
