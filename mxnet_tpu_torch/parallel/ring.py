"""Ring and Ulysses attention — sequence (context) parallelism over a
``torch.distributed`` process group; the port of
``mxnet_tpu/parallel/ring.py``.

Each rank holds a T/N slice of Q, K and V (``[B, H, T/N, D]``).
:func:`ring_attention` (the blockwise recipe of Liu et al., "Ring
Attention with Blockwise Transformers", 2023) rotates the K/V blocks to
rank+1 with ``dist.batch_isend_irecv`` while each rank accumulates its
queries' attention with an online softmax in float32; the causal mask is
the global one, offset by each block's source rank.  The JAX version is
plain ``jnp`` around ``ppermute`` (no Pallas kernel), and so is this one:
plain PyTorch around point-to-point sends.  Ulysses
(:func:`ulysses_attention`, the DeepSpeed-Ulysses recipe) swaps the
sharded axis from sequence to heads with ``dist.all_to_all_single``, runs
:func:`full_attention` (the port's ``flash_attention`` kernel) on H/N
whole sequences, and swaps back.

Both communications are autograd functions whose backward sends the
gradients the other way (the transpose JAX derives for ``ppermute`` and
``all_to_all``), so a training step differentiates through them.  JAX
rotates on every ring step, the last included; here the last rotation
is skipped, and with one rank there is none (a rank cannot send to
itself).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ['ring_attention', 'ulysses_attention', 'full_attention',
           'make_ring_attention', 'make_ulysses_attention']


def _block_update(q, k, v, m, l, o, mask=None, scale=1.0):
    """Online-softmax accumulation of one K/V block.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; m, l: [B, H, Tq]; o like q.
    """
    s = torch.einsum('bhqd,bhkd->bhqk', q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new == -inf)
    safe_m = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum('bhqk,bhkd->bhqd', p, v)
    return m_new, l_new, o_new


def _shift(tensors, group, shift):
    """Each tensor sent to rank+shift of ``group`` and received from
    rank-shift, in one ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, out in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t, to, group))
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """K/V blocks to rank+1; the backward sends the gradients to rank-1."""

    @staticmethod
    def forward(ctx, group, *blocks):
        ctx.group = group
        return tuple(_shift(blocks, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(_shift(grads, ctx.group, -1))


def ring_attention(q, k, v, group, causal=False):
    """Blockwise attention with K/V rotating around ``group``'s ranks.

    Per-rank shapes: q, k, v ``[B, H, T_local, D]``, rank r holding
    sequence positions ``[r * T_local, (r + 1) * T_local)``; returns
    ``[B, H, T_local, D]`` in q's dtype.  The scale is 1/sqrt(D)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    t_local = q.shape[2]
    # the online-softmax state accumulates in f32 whatever the input
    # dtype; the result is cast back at the end
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3], -math.inf, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    o = torch.zeros_like(q)
    pos = torch.arange(t_local, device=q.device)
    for step in range(n):
        src = (me - step) % n            # the rank the block came from
        mask = None
        if causal:
            mask = (me * t_local + pos)[:, None] >= \
                (src * t_local + pos)[None, :]
        m, l, o = _block_update(q, k, v, m, l, o, mask, scale)
        if step < n - 1:
            k, v = _Rotate.apply(group, k, v)
    return (o / l.clamp_min(1e-20)[..., None]).to(out_dtype)


def full_attention(q, k, v, causal=False):
    """Attention over whole sequences on one device, ``[B, H, T, D]``:
    the port's ``flash_attention`` (kernel #5 on a CUDA tensor, its plain
    version on a CPU one)."""
    from ..ops.attention import flash_attention
    return flash_attention(q, k, v, causal=causal)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 in equal chunks; it is its own
    transpose, so the backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g, ctx.group)


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x, group):
    """[B, H, T/N, D] -> [B, H/N, T, D]: head chunk j to rank j, the
    received sequence slices concatenated in rank order (JAX's tiled
    ``all_to_all(split_axis=1, concat_axis=2)``)."""
    n = dist.get_world_size(group)
    b, h, t, d = x.shape
    if h % n:
        raise ValueError('Ulysses attention needs the heads (%d) to divide '
                         'by the ranks (%d)' % (h, n))
    chunks = x.reshape(b, n, h // n, t, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(group, chunks)            # [N(src), B, H/N, t, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _heads_to_seq(x, group):
    """[B, H/N, T, D] -> [B, H, T/N, D], the inverse of
    :func:`_seq_to_heads`."""
    n = dist.get_world_size(group)
    b, hn, t, d = x.shape
    chunks = x.reshape(b, hn, n, t // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(group, chunks)            # [N(src), B, H/N, t, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hn, t // n, d)


def ulysses_attention(q, k, v, group, causal=False):
    """DeepSpeed-Ulysses attention over ``group``: sequence-sharded
    ``[B, H, T_local, D]`` in and out; full attention on H/N heads in
    between (needs H % N == 0).  The scale is 1/sqrt(D)."""
    oh = full_attention(_seq_to_heads(q, group), _seq_to_heads(k, group),
                        _seq_to_heads(v, group), causal=causal)
    return _heads_to_seq(oh, group)


def make_ring_attention(mesh, seq_axis='seq', causal=False):
    """Sequence-parallel attention over ``mesh``'s ``seq_axis`` group: a
    function of each rank's ``[B, H, T/N, D]`` shards returning its output
    shard (the JAX version takes and returns arrays sharded on T)."""
    group = mesh.get_group(seq_axis)

    def attn(q, k, v):
        return ring_attention(q, k, v, group, causal=causal)

    return attn


def make_ulysses_attention(mesh, seq_axis='seq', causal=False):
    """:func:`make_ring_attention` with the all-to-all head swap:
    better when H >= N and the all-to-all fits the interconnect."""
    group = mesh.get_group(seq_axis)

    def attn(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal)

    return attn
