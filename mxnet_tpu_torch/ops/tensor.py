"""Tensor operators: elemwise / broadcast / reduce / matrix / indexing /
init / ordering / sampling families.

The port of ``mxnet_tpu/ops/tensor.py``, one registration per op in the
JAX module's order: the unary functors (``:31-74``), ``stop_gradient`` /
``make_loss`` / ``Cast`` (``:76-117``), the binary and ``_*_scalar``
families (``:124-173``), the broadcast family (``:180-211``), the
reductions (``:219-261``), the matrix ops (``:268-418``), indexing
(``:425-452``), the constant leaves ``_zeros`` / ``_ones`` / ``_full`` /
``_arange`` (``:459-484``), ordering (``:491-517``), sampling
(``:526-549``) and the rest (``:556-617``).

Tie and edge semantics follow JAX: ``maximum`` / ``minimum`` (and
``clip``) split a tie's gradient, ``mod`` takes the divisor's sign,
comparisons return the lhs dtype, ``argmax`` of ties takes the first
index, ``one_hot`` of an out-of-range index is a zero row.  ``dot`` and
``batch_dot`` are plain products, as in the JAX package (``jnp.dot``
outside any kernel): ``torch.matmul``.  An op with no input makes its
output on the device of its ``ctx`` attr (``context.as_torch_device``);
the samplers draw from that device's generator (``random.generator``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import resolve_dtype
from ..context import as_torch_device
from .registry import alias, register, register_simple

__all__ = ['arange']

# ---------------------------------------------------------------------------
# Elemwise unary (mshadow_op.h functors)
# ---------------------------------------------------------------------------


def _cbrt(x):
    # torch has no cbrt: the real cube root, computed in float64
    return (torch.sign(x) * x.abs().double().pow(1.0 / 3.0)).to(x.dtype)


_UNARY = {
    'negative': torch.neg,
    'abs': torch.abs,
    'sign': torch.sign,
    'round': torch.round,       # half to even, as jnp.round
    'rint': torch.round,
    'ceil': torch.ceil,
    'floor': torch.floor,
    'fix': torch.trunc,
    'square': torch.square,
    'sqrt': torch.sqrt,
    'rsqrt': lambda x: 1.0 / torch.sqrt(x),
    'cbrt': _cbrt,
    'rcbrt': lambda x: 1.0 / _cbrt(x),
    'exp': torch.exp,
    'log': torch.log,
    'log10': torch.log10,
    'log2': torch.log2,
    'log1p': torch.log1p,
    'expm1': torch.expm1,
    'sin': torch.sin,
    'cos': torch.cos,
    'tan': torch.tan,
    'arcsin': torch.asin,
    'arccos': torch.acos,
    'arctan': torch.atan,
    'sinh': torch.sinh,
    'cosh': torch.cosh,
    'tanh': torch.tanh,
    'arcsinh': torch.asinh,
    'arccosh': torch.acosh,
    'arctanh': torch.atanh,
    'degrees': torch.rad2deg,
    'radians': torch.deg2rad,
    'sigmoid': torch.sigmoid,
    'relu': torch.relu,
    'softsign': F.softsign,
    'gamma': lambda x: torch.exp(torch.lgamma(x)),
    'gammaln': torch.lgamma,
    'logical_not': lambda x: (x == 0).to(x.dtype),
}

for _name, _fn in _UNARY.items():
    register_simple(_name, _fn)

register_simple('identity', lambda x: x)
alias('_copy', 'identity')
alias('BlockGrad', 'stop_gradient')
register_simple('stop_gradient', torch.Tensor.detach)


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the backward injects ``grad_scale`` everywhere,
    whatever the head gradient (make_loss-inl.h; the JAX op's
    custom_vjp returns a float32 fill)."""

    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.shape = x.shape
        ctx.device = x.device
        ctx.grad_scale = grad_scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full(ctx.shape, ctx.grad_scale, dtype=torch.float32,
                          device=ctx.device), None


def _make_loss_apply(attrs, inputs, is_train, rng):
    return [_MakeLossFn.apply(inputs[0],
                              float(attrs.get('grad_scale', 1.0)))], {}


register('make_loss', _make_loss_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'grad_scale': 1.0, 'valid_thresh': 0.0,
                        'normalization': 'null'},
         hint='make_loss')
alias('MakeLoss', 'make_loss')
register_simple('_identity_with_attr_like_rhs', lambda lhs, rhs: lhs,
                ninputs=2)
# the device-boundary copy of group2ctx placement is made by the
# executor between segments (executor._placed); a graph naming the op
# gets an identity, as in the JAX package
register_simple('_CrossDeviceCopy', lambda x: x)


def _clip(x, a_min=None, a_max=None):
    # jnp.clip is maximum-then-minimum: ties split the gradient 0.5/0.5
    # (the bounds filled on the device: a graph capture refuses a copy
    # from the host)
    if a_min is not None:
        x = torch.maximum(x, torch.full((), float(a_min), dtype=x.dtype,
                                        device=x.device))
    if a_max is not None:
        x = torch.minimum(x, torch.full((), float(a_max), dtype=x.dtype,
                                        device=x.device))
    return x


register_simple('clip', _clip, attr_defaults={'a_min': None, 'a_max': None})
register_simple('Cast', lambda x, dtype='float32': x.to(resolve_dtype(dtype)),
                attr_defaults={'dtype': 'float32'})
alias('cast', 'Cast')

# ---------------------------------------------------------------------------
# Elemwise binary and the scalar variants
# ---------------------------------------------------------------------------


def _compare(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


_BINARY = {
    # jnp.mod takes the divisor's sign, as torch.remainder does
    '_plus': torch.add, '_minus': torch.sub, '_mul': torch.mul,
    '_div': torch.div, '_mod': torch.remainder, '_power': torch.pow,
    '_maximum': torch.maximum, '_minimum': torch.minimum,
    '_hypot': torch.hypot,
    '_equal': _compare(torch.eq), '_not_equal': _compare(torch.ne),
    '_greater': _compare(torch.gt), '_greater_equal': _compare(torch.ge),
    '_lesser': _compare(torch.lt), '_lesser_equal': _compare(torch.le),
}

for _name, _fn in _BINARY.items():
    register_simple(_name, _fn, ninputs=2)

alias('elemwise_add', '_plus')
alias('elemwise_sub', '_minus')
alias('_sub', '_minus')
alias('_grad_add', '_plus')
alias('elemwise_mul', '_mul')
alias('elemwise_div', '_div')


def _s(x, scalar):
    """``scalar`` as a 0-d tensor on x's device: it promotes as a JAX weak
    type does (an int array with a float scalar gives float32, a float16
    array stays float16).  A fill on the device, not a copy from the
    host, so a CUDA graph can capture it."""
    return torch.full((), float(scalar), device=x.device)


for _name, _fn in [
        ('_plus_scalar', lambda x, scalar=0.0: x + scalar),
        ('_minus_scalar', lambda x, scalar=0.0: x - scalar),
        ('_rminus_scalar', lambda x, scalar=0.0: scalar - x),
        ('_mul_scalar', lambda x, scalar=1.0: x * scalar),
        ('_div_scalar', lambda x, scalar=1.0: x / scalar),
        ('_rdiv_scalar', lambda x, scalar=1.0: scalar / x),
        ('_mod_scalar', lambda x, scalar=1.0: torch.remainder(x, scalar)),
        ('_rmod_scalar',
         lambda x, scalar=1.0: torch.remainder(_s(x, scalar), x)),
        ('_power_scalar', lambda x, scalar=1.0: torch.pow(x, scalar)),
        ('_rpower_scalar', lambda x, scalar=1.0: torch.pow(scalar, x)),
        ('_maximum_scalar',
         lambda x, scalar=0.0: torch.maximum(x, _s(x, scalar))),
        ('_minimum_scalar',
         lambda x, scalar=0.0: torch.minimum(x, _s(x, scalar))),
        ('_hypot_scalar',
         lambda x, scalar=0.0: torch.hypot(x, torch.full_like(x, scalar))),
        ('_equal_scalar', lambda x, scalar=0.0: (x == scalar).to(x.dtype)),
        ('_not_equal_scalar',
         lambda x, scalar=0.0: (x != scalar).to(x.dtype)),
        ('_greater_scalar', lambda x, scalar=0.0: (x > scalar).to(x.dtype)),
        ('_greater_equal_scalar',
         lambda x, scalar=0.0: (x >= scalar).to(x.dtype)),
        ('_lesser_scalar', lambda x, scalar=0.0: (x < scalar).to(x.dtype)),
        ('_lesser_equal_scalar',
         lambda x, scalar=0.0: (x <= scalar).to(x.dtype)),
]:
    register_simple(_name, _fn, attr_defaults={'scalar': 0.0})


def _smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(x.abs() < 1.0 / s2, 0.5 * (scalar * x) ** 2,
                       x.abs() - 0.5 / s2)


register_simple('smooth_l1', _smooth_l1, attr_defaults={'scalar': 1.0})

# ---------------------------------------------------------------------------
# Broadcast binary family
# ---------------------------------------------------------------------------

for _name, _fn in [
        ('broadcast_add', torch.add), ('broadcast_plus', torch.add),
        ('broadcast_sub', torch.sub), ('broadcast_minus', torch.sub),
        ('broadcast_mul', torch.mul), ('broadcast_div', torch.div),
        ('broadcast_mod', torch.remainder), ('broadcast_power', torch.pow),
        ('broadcast_maximum', torch.maximum),
        ('broadcast_minimum', torch.minimum),
        ('broadcast_hypot', torch.hypot),
        ('broadcast_equal', _compare(torch.eq)),
        ('broadcast_not_equal', _compare(torch.ne)),
        ('broadcast_greater', _compare(torch.gt)),
        ('broadcast_greater_equal', _compare(torch.ge)),
        ('broadcast_lesser', _compare(torch.lt)),
        ('broadcast_lesser_equal', _compare(torch.le)),
]:
    register_simple(_name, _fn, ninputs=2)


def _broadcast_to(x, shape=()):
    # a 0 keeps the input's dim
    return torch.broadcast_to(x, tuple(int(s) if int(s) != 0 else x.shape[i]
                                       for i, s in enumerate(shape)))


def _broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(x, tuple(shape))


register_simple('broadcast_to', _broadcast_to, attr_defaults={'shape': ()})
register_simple('broadcast_axis', _broadcast_axis,
                attr_defaults={'axis': (), 'size': ()})
alias('broadcast_axes', 'broadcast_axis')

# ---------------------------------------------------------------------------
# Reductions, with the reference's axis / keepdims / exclude semantics
# ---------------------------------------------------------------------------


def _reduce_axes(x, axis, exclude):
    if axis is None or axis == ():
        return tuple(range(x.ndim))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % x.ndim for a in ax)
    if exclude:
        ax = tuple(i for i in range(x.ndim) if i not in ax)
    return ax


def _prod_axes(x, ax, keepdims):
    # torch.prod reduces one axis at a time
    out = x
    for a in sorted(ax, reverse=True):
        out = torch.prod(out, dim=a, keepdim=True)
    if not keepdims:
        out = out.reshape([d for i, d in enumerate(x.shape) if i not in ax])
    return out


def _make_reduce(kind):
    def f(x, axis=None, keepdims=False, exclude=False):
        ax = _reduce_axes(x, axis, exclude)
        kd = bool(keepdims)
        if kind in ('max', 'min'):
            fn = torch.amax if kind == 'max' else torch.amin
            return fn(x, dim=ax, keepdim=kd) if ax else x
        if kind in ('prod', 'nanprod'):
            src = torch.where(torch.isnan(x), torch.ones_like(x), x) \
                if kind == 'nanprod' else x
            out = _prod_axes(src, ax, kd)
        elif kind == 'mean':
            src = x if x.is_floating_point() else x.float()
            return torch.mean(src, dim=ax, keepdim=kd) if ax else src
        else:
            fn = torch.nansum if kind == 'nansum' else torch.sum
            out = fn(x, dim=ax, keepdim=kd) if ax else x
        # jnp keeps an integer input's width (torch widens to int64)
        return out if out.is_floating_point() else out.to(x.dtype)
    return f


for _name in ('sum', 'mean', 'prod', 'nansum', 'nanprod', 'max', 'min'):
    register_simple(_name, _make_reduce(_name),
                    attr_defaults={'axis': None, 'keepdims': False,
                                   'exclude': False})

alias('sum_axis', 'sum')
alias('max_axis', 'max')
alias('min_axis', 'min')


def _make_arg(fn):
    # ties take the first index; axis None flattens; float32 indices
    def f(x, axis=None, keepdims=False):
        if axis is None:
            return fn(x.reshape(-1)).to(torch.float32)
        return fn(x, dim=int(axis), keepdim=bool(keepdims)) \
            .to(torch.float32)
    return f


register_simple('argmax', _make_arg(torch.argmax),
                attr_defaults={'axis': None, 'keepdims': False})
register_simple('argmin', _make_arg(torch.argmin),
                attr_defaults={'axis': None, 'keepdims': False})
register_simple('argmax_channel',
                lambda x: torch.argmax(x, dim=1).to(torch.float32))
register_simple('norm',
                lambda x: torch.sqrt(torch.sum(torch.square(x))).reshape(1))

# ---------------------------------------------------------------------------
# Matrix ops (matrix_op.cc / matrix_op-inl.h)
# ---------------------------------------------------------------------------


def _reshape(x, shape=(), reverse=False, target_shape=None,
             keep_highest=False):
    # the reference's special codes 0 (keep), -1 (infer), -2 (copy rest),
    # -3 (merge two), -4 (split) — matrix_op-inl.h:40-128
    if target_shape:  # legacy attr
        shape = target_shape
    src = list(x.shape)
    if reverse:
        src = src[::-1]
        shape = tuple(shape)[::-1]
    out = []
    src_i = 0
    shape = list(shape)
    i = 0
    while i < len(shape):
        s = int(shape[i])
        if s == 0:
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            a, b = int(shape[i + 1]), int(shape[i + 2])
            if a == -1:
                a = src[src_i] // b
            if b == -1:
                b = src[src_i] // a
            out.extend([a, b])
            src_i += 1
            i += 2
        else:
            out.append(s)
            src_i += 1
        i += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(x, tuple(out))


register_simple('Reshape', _reshape,
                attr_defaults={'shape': (), 'reverse': False,
                               'target_shape': None, 'keep_highest': False})
alias('reshape', 'Reshape')

register_simple('Flatten', lambda x: torch.reshape(x, (x.shape[0], -1)))
alias('flatten', 'Flatten')


def _reverse_axes(x):
    return x.permute(tuple(range(x.ndim - 1, -1, -1)))


register_simple('transpose', lambda x, axes=(): x.permute(
    tuple(axes)) if axes else _reverse_axes(x), attr_defaults={'axes': ()})
register_simple('expand_dims', lambda x, axis=0: torch.unsqueeze(
    x, int(axis)), attr_defaults={'axis': 0})


def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape(1)
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    # jnp.dot: the last axis of a against the second-to-last of b
    return torch.tensordot(a, b, dims=([a.ndim - 1],
                                       [max(b.ndim - 2, 0)]))


register_simple('dot', _dot, ninputs=2,
                attr_defaults={'transpose_a': False, 'transpose_b': False})


def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


register_simple('batch_dot', _batch_dot, ninputs=2,
                attr_defaults={'transpose_a': False, 'transpose_b': False})


def _region(begin, end):
    return tuple(slice(b, e) for b, e in zip(begin, end)) or (Ellipsis,)


register_simple('slice', lambda x, begin=(), end=(): x[_region(begin, end)],
                attr_defaults={'begin': (), 'end': ()})
alias('crop', 'slice')


def _slice_assign(lhs, rhs, begin=(), end=()):
    """rhs into a region of a copy of lhs (matrix_op.cc:222)."""
    out = lhs.clone()
    out[_region(begin, end)] = rhs
    return out


register_simple('_slice_assign', _slice_assign, ninputs=2,
                input_names=['lhs', 'rhs'],
                attr_defaults={'begin': (), 'end': ()})
alias('_crop_assign', '_slice_assign')


def _crop_assign_scalar(x, begin=(), end=(), scalar=0.0):
    """A scalar into a region of a copy of x (matrix_op.cc:247)."""
    out = x.clone()
    out[_region(begin, end)] = scalar
    return out


register_simple('_crop_assign_scalar', _crop_assign_scalar,
                attr_defaults={'begin': (), 'end': (), 'scalar': 0.0})


def _slice_axis(x, axis=0, begin=0, end=None):
    axis = int(axis) % x.ndim
    size = x.shape[axis]
    b = int(begin)
    e = size if end is None else int(end)
    if b < 0:
        b += size
    if e < 0:
        e += size
    # Python slicing clamps to the dimension (an end past it, or before
    # the begin, gives fewer or no rows), as the JAX op's x[b:e] does
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(b, e)
    return x[tuple(idx)]


register_simple('slice_axis', _slice_axis,
                attr_defaults={'axis': 0, 'begin': 0, 'end': None})

register_simple('flip', lambda x, axis=0: torch.flip(
    x, (axis,) if isinstance(axis, int) else tuple(axis)),
    attr_defaults={'axis': 0})
alias('reverse', 'flip')

register_simple('repeat', lambda x, repeats=1, axis=None:
                torch.repeat_interleave(x, int(repeats), dim=axis),
                attr_defaults={'repeats': 1, 'axis': None})
register_simple('tile', lambda x, reps=(): torch.tile(x, tuple(reps)),
                attr_defaults={'reps': ()})


def _pad(x, pad_width=(), mode='constant', constant_value=0.0):
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    widths = []                 # F.pad lists the LAST axis first
    for lo, hi in reversed(pw):
        widths += [lo, hi]
    if mode == 'constant':
        return F.pad(x, widths, value=float(constant_value))
    # edge / reflect pad the trailing axes of an (N, C, ...) input
    lead = next((i for i, p in enumerate(pw) if p != (0, 0)), len(pw))
    return F.pad(x, widths[:2 * (len(pw) - lead)],
                 mode={'edge': 'replicate', 'reflect': 'reflect'}[mode])


register_simple('pad', _pad, attr_defaults={'pad_width': (),
                                            'mode': 'constant',
                                            'constant_value': 0.0})
alias('Pad', 'pad')

register_simple('SwapAxis', lambda x, dim1=0, dim2=0: x.transpose(
    int(dim1), int(dim2)), attr_defaults={'dim1': 0, 'dim2': 0})
alias('swapaxes', 'SwapAxis')

# ---------------------------------------------------------------------------
# Indexing ops (indexing_op.cc)
# ---------------------------------------------------------------------------


def fill_index(ids, n):
    """``jnp.take``'s default reading of integer ``ids`` into an axis of
    length ``n``: an id in [-n, 0) wraps to n + id, one outside [-n, n)
    reads a NaN.  Returns the index to gather (always in [0, n): a gather
    at a negative index device-asserts on the card) and the mask of the
    ids that are kept, with no host sync."""
    ids = torch.where(ids < 0, ids + n, ids)
    return ids.clamp(0, n - 1), (ids >= 0) & (ids < n)


def _take_along_axis(a, indices, axis):
    """``jnp.take_along_axis`` in its default "fill" mode: an index in
    [-n, 0) counts from the end, and one past either end reads the fill
    value (NaN for floats, the most negative value for signed integers,
    the largest for unsigned ones).  The gather reads a clamped index and
    a ``where`` puts the fill in, so the card sees no out-of-range index
    (which would be a device-side assert)."""
    n = a.shape[axis]
    idx = indices.long()                # truncation, as astype(int32)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.gather(a, axis, idx.clamp(0, max(n - 1, 0)))
    if a.dtype.is_floating_point or a.dtype.is_complex:
        fill = float('nan')
    elif a.dtype == torch.bool:
        fill = True
    elif a.dtype == torch.uint8:
        fill = torch.iinfo(a.dtype).max
    else:
        fill = torch.iinfo(a.dtype).min
    return torch.where(ok, out, torch.full_like(out, fill))


def _take(a, indices, axis=0, mode='clip'):
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    idx = indices.long()            # truncation, as astype(int32)
    idx = idx.remainder(n) if mode == 'wrap' else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


register_simple('take', _take, ninputs=2, input_names=['a', 'indices'],
                attr_defaults={'axis': 0, 'mode': 'clip'})
register_simple('batch_take', lambda a, indices: _take_along_axis(
    a, indices[:, None], 1)[:, 0], ninputs=2, input_names=['a', 'indices'])


def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype='float32'):
    # jax.nn.one_hot: an index outside [0, depth) gives a zero row
    hot = indices.long()[..., None] == torch.arange(
        int(depth), device=indices.device)
    oh = hot.to(torch.float32)
    return (oh * on_value + (1.0 - oh) * off_value).to(resolve_dtype(dtype))


register_simple('one_hot', _one_hot,
                attr_defaults={'depth': 0, 'on_value': 1.0,
                               'off_value': 0.0, 'dtype': 'float32'})
register_simple('where', lambda condition, x, y: torch.where(
    condition.bool(), x, y), ninputs=3,
    input_names=['condition', 'x', 'y'])

# ---------------------------------------------------------------------------
# Init ops (init_op.cc): the constant leaves, made on the device of ctx
# ---------------------------------------------------------------------------


def _leaf(make):
    def f(shape=(), dtype='float32', ctx=None, **kw):
        return make(tuple(int(s) for s in shape), resolve_dtype(dtype),
                    as_torch_device(ctx), **kw)
    return f


register_simple('_zeros', _leaf(lambda shp, dt, dev: torch.zeros(
    shp, dtype=dt, device=dev)), ninputs=0, input_names=[],
    attr_defaults={'shape': (), 'dtype': 'float32', 'ctx': None})
register_simple('_ones', _leaf(lambda shp, dt, dev: torch.ones(
    shp, dtype=dt, device=dev)), ninputs=0, input_names=[],
    attr_defaults={'shape': (), 'dtype': 'float32', 'ctx': None})
register_simple('_full', _leaf(lambda shp, dt, dev, value=0.0: torch.full(
    shp, value, dtype=dt, device=dev)), ninputs=0, input_names=[],
    attr_defaults={'shape': (), 'value': 0.0, 'dtype': 'float32',
                   'ctx': None})


def arange(start=0.0, stop=None, step=1.0, repeat=1, dtype=None,
           device=None):
    """``jnp.arange(start, stop, step)`` then each value ``repeat``
    times; a missing ``stop`` counts from 0 to ``start``."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=resolve_dtype(dtype),
                       device=device)
    return torch.repeat_interleave(out, int(repeat)) if int(repeat) != 1 \
        else out


register_simple('_arange', lambda start=0.0, stop=None, step=1.0, repeat=1,
                dtype='float32', ctx=None: arange(
                    start, stop, step, repeat, dtype, as_torch_device(ctx)),
                ninputs=0, input_names=[],
                attr_defaults={'start': 0.0, 'stop': None, 'step': 1.0,
                               'repeat': 1, 'dtype': 'float32', 'ctx': None})
register_simple('zeros_like', torch.zeros_like)
register_simple('ones_like', torch.ones_like)

# ---------------------------------------------------------------------------
# Ordering ops (ordering_op.cc).  Stable sorts: among ties the lower index
# comes first, as lax.top_k and jnp.argsort give.
# ---------------------------------------------------------------------------


def _topk(x, axis=-1, k=1, ret_typ='indices', is_ascend=False):
    axis = x.ndim - 1 if axis is None else int(axis) % x.ndim
    vals, idx = torch.sort(x.movedim(axis, -1), dim=-1,
                           descending=not is_ascend, stable=True)
    vals = vals[..., :int(k)].movedim(-1, axis)
    idx = idx[..., :int(k)].movedim(-1, axis).to(torch.float32)
    if ret_typ == 'value':
        return vals
    if ret_typ == 'both':
        return vals, idx
    return idx


register_simple('topk', _topk,
                attr_defaults={'axis': -1, 'k': 1, 'ret_typ': 'indices',
                               'is_ascend': False})
def _sort(x, axis=-1, is_ascend=True):
    """Values and indices of a stable sort along ``axis``; ``axis=None``
    sorts the flattened array, as ``jnp.sort(x, axis=None)`` does."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sort(x, dim=int(axis), descending=not is_ascend,
                      stable=True)


register_simple('sort', lambda x, axis=-1, is_ascend=True: _sort(
    x, axis, is_ascend)[0], attr_defaults={'axis': -1, 'is_ascend': True})
register_simple('argsort', lambda x, axis=-1, is_ascend=True: _sort(
    x, axis, is_ascend)[1].to(torch.float32),
    attr_defaults={'axis': -1, 'is_ascend': True})

# ---------------------------------------------------------------------------
# Sampling ops (sample_op.cc), from the per-device generator
# ---------------------------------------------------------------------------


def _sampler(fill):
    def f(a, b, shape=(), dtype='float32', ctx=None):
        from ..random import generator
        dev = as_torch_device(ctx)
        t = torch.empty(tuple(int(s) for s in shape),
                        dtype=resolve_dtype(dtype), device=dev)
        return fill(t, float(a), float(b), generator(dev))
    return f


_uniform = _sampler(lambda t, lo, hi, g: t.uniform_(lo, hi, generator=g))
_normal = _sampler(lambda t, loc, scale, g: t.normal_(loc, scale,
                                                      generator=g))
register_simple('_random_uniform', lambda low=0.0, high=1.0, shape=(),
                dtype='float32', ctx=None, rng=None: _uniform(
                    low, high, shape, dtype, ctx),
                ninputs=0, input_names=[], takes_rng=True,
                attr_defaults={'low': 0.0, 'high': 1.0, 'shape': (),
                               'dtype': 'float32', 'ctx': None})
register_simple('_random_normal', lambda loc=0.0, scale=1.0, shape=(),
                dtype='float32', ctx=None, rng=None: _normal(
                    loc, scale, shape, dtype, ctx),
                ninputs=0, input_names=[], takes_rng=True,
                attr_defaults={'loc': 0.0, 'scale': 1.0, 'shape': (),
                               'dtype': 'float32', 'ctx': None})
alias('_sample_uniform', '_random_uniform')
alias('_sample_normal', '_random_normal')
alias('uniform', '_random_uniform')
alias('normal', '_random_normal')

# ---------------------------------------------------------------------------
# N-ary sum (elemwise_sum.cc), and the rest
# ---------------------------------------------------------------------------


def _num_args_names(attrs):
    return ['arg%d' % i for i in range(int(attrs.get('num_args', 1)))]


def _add_n_apply(attrs, inputs, is_train, rng):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return [out], {}


register('add_n', _add_n_apply, input_names=_num_args_names,
         num_outputs=lambda attrs: 1, attr_defaults={'num_args': 1})
alias('ElementWiseSum', 'add_n')
alias('_sum', 'add_n')

register_simple('reciprocal', lambda x: 1.0 / x)
register_simple('trunc', torch.trunc)
register_simple('diag', lambda x, k=0, axis1=0, axis2=1:
                torch.diag(x, int(k)) if x.ndim <= 2
                else torch.diagonal(x, int(k), int(axis1), int(axis2)),
                attr_defaults={'k': 0, 'axis1': 0, 'axis2': 1})


def _stack_apply(attrs, inputs, is_train, rng):
    return [torch.stack(list(inputs), dim=int(attrs.get('axis', 0)))], {}


register('stack', _stack_apply, input_names=_num_args_names,
         num_outputs=lambda attrs: 1, attr_defaults={'num_args': 1, 'axis': 0})


def _pick(data, index, axis=-1, keepdims=False):
    axis = data.ndim - 1 if axis is None else int(axis) % data.ndim
    out = _take_along_axis(data, index.unsqueeze(axis), axis)
    return out if keepdims else out.squeeze(axis)


register_simple('pick', _pick, ninputs=2, input_names=['data', 'index'],
                attr_defaults={'axis': -1, 'keepdims': False})
register_simple('choose_element_0index',
                lambda lhs, rhs: _pick(lhs, rhs, axis=1),
                ninputs=2, input_names=['lhs', 'rhs'])


def _fill_element_0index(lhs, mhs, rhs):
    out = lhs.clone()
    out[torch.arange(lhs.shape[0], device=lhs.device), rhs.long()] = mhs
    return out


register_simple('fill_element_0index', _fill_element_0index, ninputs=3,
                input_names=['lhs', 'mhs', 'rhs'])
