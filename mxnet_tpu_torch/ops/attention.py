"""Flash attention: online-softmax attention with the per-row log-sum-exp.

The counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  The forward is
the hand-written CUDA kernel ``csrc/flash_attention.cu`` (built and bound
by ``ops/_kernels.py``), which replaces the TPU kernel ``_flash_fwd`` /
``_fwd_kernel``: each (batch*head, query tile) walks the key/value
tiles with the softmax state (m, l, acc) in f32, so the full [Tq, Tk]
score matrix never reaches device memory.  It returns O in
q's dtype and the f32 row lse.  Causal masking is bottom-right aligned
(row r sees columns <= r + Tk - Tq) with the reference's finite mask
constant ``NEG_INF``; key tiles strictly above the diagonal are skipped.

The kernel has three routes, chosen by :func:`attention_route` before
the launch and counted in ``flash_attention.launches_by_route``:
``sm90`` (bfloat16 with D 64 or 128: TMA loads into an mbarrier ring,
both products as wgmma, P kept in registers as the A operand of the PV
product), ``mma`` (the other bfloat16 head dims: ``mma.sync``, the first
design) and ``simt`` (float32).  bfloat16 runs both products on the
tensor cores (bf16 in, f32 out).  The probabilities P are rounded to bf16
for the PV product, where the reference keeps them in f32
(``pallas_attention.py:144-149``); each term of O then carries a
relative error of at most 2^-8 (bf16's unit roundoff), and O one more
bf16 rounding on each side, so the kernel stays within 3 * 2^-8 (~1.2%)
of (P @ |V|) of the plain version:
``chip_smoke.py`` holds it to 2e-2 of that magnitude.  float32 takes a
SIMT path in full f32.  The kernel takes a head dim D that is a multiple
of 8 up to 128 (``MAX_HEAD_DIM``); another D on a CUDA tensor raises
:class:`MXNetError`.

The backward is the reference's ``_flash_bwd`` (``:232-275``) in plain
PyTorch: blockwise recompute from the saved lse over query blocks of
``_pick_block(tq, block_q)`` rows with dK/dV accumulators, never the full
[Tq, Tk] matrix.  It is plain JAX in the reference.

On a CUDA tensor ``flash_attention`` launches the kernel or raises; a CPU
or ``meta`` tensor takes the plain version ``flash_attention_plain`` (the
reference's ``_ref_attention``).  Causal attention with Tq > Tk leaves
leading rows fully masked; as in the reference (``:322-323``) it goes to
the dense form, which gives such rows uniform weights.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _kernels
from .fused import _count, _flops, _raise_launch, _sm_count

__all__ = ['flash_attention', 'flash_attention_plain', 'NEG_INF',
           'MAX_HEAD_DIM', 'attention_route', 'ROUTES']

NEG_INF = -1e30
MAX_HEAD_DIM = 128
DEFAULT_BLOCK_Q = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ('sm90', 'mma', 'simt')
SM90_HEAD_DIMS = (64, 128)


def attention_route(dtype, d, ptrs):
    """The route of one kernel call: ``'simt'`` for float32; for bfloat16
    ``'sm90'`` when the head dim D is 64 or 128 (whole 128-byte rows of
    64-column TMA boxes) and every base address in ``ptrs`` (Q, K, V, O)
    is 16-byte aligned, else ``'mma'``.  A pure function of dtype, shape
    and alignment, decided before the launch."""
    if dtype == torch.float32:
        return 'simt'
    if dtype != torch.bfloat16:
        raise TypeError('no flash_attention route for %s' % dtype)
    if d not in SM90_HEAD_DIMS or any(p % 16 for p in ptrs):
        return 'mma'
    return 'sm90'


def _pick_block(t, pref):
    """The reference's block choice (``pallas_attention.py:60-67``): the
    largest candidate that tiles ``t`` exactly, else None."""
    for b in sorted({pref, 1024, 512, 256, 128}, reverse=True):
        if b <= t and t % b == 0 and b % 8 == 0:
            return b
    return t if (t <= 128 and t % 8 == 0) else None


def _causal_keep(tq, tk, device, row0=0, rows=None):
    """Bool mask of the rows ``row0 .. row0+rows`` of the bottom-right
    aligned causal pattern: row r keeps columns <= r + tk - tq."""
    rows = tq if rows is None else rows
    r = torch.arange(row0, row0 + rows, device=device)[:, None]
    c = torch.arange(tk, device=device)[None, :]
    return r + (tk - tq) >= c


def flash_attention_plain(q, k, v, scale, causal):
    """The plain version, the reference's ``_ref_attention``: q, k, v
    ``[BH, T, D]`` -> ``(o in q's dtype, lse in f32 [BH, Tq])``, computed
    densely in f32."""
    s = torch.einsum('btd,bsd->bts', q.float(), k.float()) * scale
    if causal:
        keep = _causal_keep(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum('bts,bsd->btd', p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_flops(q, k):
    """The FLOPs of one launch as FlopCounterMode counts the plain
    version: its two dense products, 4·BH·Tq·Tk·D (a causal mask is not
    discounted)."""
    bh, tq, d = q.shape
    return 4 * bh * tq * k.shape[1] * d


def _check(q, k, v):
    for nm, t in (('q', q), ('k', k), ('v', v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError('flash_attention: %s must be a torch.Tensor' % nm)
        if t.ndim != 3:
            raise ValueError('flash_attention: %s must be [BH, T, D], got '
                             'shape %s' % (nm, tuple(t.shape)))
        if t.dtype not in _DTYPE_CODE:
            raise TypeError('flash_attention: %s must be float32 or '
                            'bfloat16, got %s' % (nm, t.dtype))
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError('flash_attention: q, k and v must share one '
                             'dtype and device')
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError('flash_attention: q %s, k %s, v %s do not match'
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.device.type not in ('cuda', 'cpu', 'meta'):
        raise MXNetError('flash_attention: unsupported device %s' % q.device)


def _aligned(t):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, scale, causal, route=None):
    """Launch the kernel on ``route`` (default: :func:`attention_route`'s
    for the aligned, contiguous tensors the kernel reads); returns
    ``(o, lse)``."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if d % 8 or d > MAX_HEAD_DIM:
        raise MXNetError('flash_attention: the CUDA kernel takes a head dim '
                         'that is a multiple of 8 up to %d, got %d'
                         % (MAX_HEAD_DIM, d))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or tk == 0:
        return o.zero_(), lse.fill_(NEG_INF)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    route = route or attention_route(q.dtype, d, ptrs)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == 'sm90':
            # persistent blocks: one per SM, at most one per 128-row tile
            grid = min(bh * -(-tq // 128), _sm_count(q.device))
            err = _kernels.load('flash_attention',
                                'mxtpu_flash_attention_sm90')(
                *ptrs, lse.data_ptr(), bh, tq, tk, d, float(scale),
                int(causal), grid, stream)
        else:
            err = _kernels.load('flash_attention')(
                *ptrs, lse.data_ptr(), bh, tq, tk, d, float(scale),
                int(causal), _DTYPE_CODE[q.dtype], stream)
    if err:
        _raise_launch('flash_attention', err)
    _count(flash_attention, route)
    _flops(flash_attention_flops(q, k))
    return o, lse


def _flash_bwd(scale, causal, block_q, q, k, v, o, lse, g):
    """The reference's ``_flash_bwd``: a loop over query blocks carrying
    the dK/dV accumulators; one [BH, bq, Tk] score block at a time."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    tq = qf.shape[1]
    delta = torch.sum(gf * o.float(), dim=-1)                # [BH, Tq]
    bq = _pick_block(tq, block_q) or tq
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.empty_like(qf)
    for r0 in range(0, tq, bq):
        qb, gb = qf[:, r0:r0 + bq], gf[:, r0:r0 + bq]
        s = torch.einsum('btd,bsd->bts', qb, kf) * scale
        if causal:
            keep = _causal_keep(tq, kf.shape[1], s.device, r0, bq)
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[:, r0:r0 + bq, None])
        dv += torch.einsum('bts,btd->bsd', p, gb)
        dp = torch.einsum('btd,bsd->bts', gb, vf)
        ds = p * (dp - delta[:, r0:r0 + bq, None])
        dq[:, r0:r0 + bq] = torch.einsum('bts,bsd->btd', ds, kf) * scale
        dk += torch.einsum('bts,btd->bsd', ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if q.device.type == 'cuda':
            o, lse = _launch(q, k, v, scale, causal)
        else:
            o, lse = flash_attention_plain(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, g):
        return _flash_bwd(ctx.scale, ctx.causal, DEFAULT_BLOCK_Q,
                          *ctx.saved_tensors, g) + (None, None)


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused multi-head attention (``pallas_attention.flash_attention``).

    q, k, v: ``[B, H, T, D]`` or ``[BH, T, D]``, float32 or bfloat16;
    returns the attention output with q's shape and dtype.
    Differentiable.  ``scale`` defaults to 1/sqrt(D).  A CUDA tensor runs
    the kernel on :func:`attention_route`'s route
    (``flash_attention.launches`` and ``.launches_by_route`` count its
    launches), a CPU tensor the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    squeeze = q.ndim == 4
    if squeeze:
        b, h, t, d = q.shape
        q3 = q.reshape(b * h, t, d)
        k3 = k.reshape(b * h, k.shape[2], d)
        v3 = v.reshape(b * h, v.shape[2], d)
    else:
        q3, k3, v3 = q, k, v
    _check(q3, k3, v3)
    if causal and q3.shape[1] > k3.shape[1]:
        o3, _ = flash_attention_plain(q3, k3, v3, float(scale), True)
    else:
        o3 = _FlashFn.apply(q3, k3, v3, float(scale), bool(causal))
    return o3.reshape(q.shape) if squeeze else o3


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
