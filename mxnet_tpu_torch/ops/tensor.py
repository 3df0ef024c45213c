"""Tensor operators of the ResNet and transformer-LM paths.

The port of the matching entries of ``mxnet_tpu/ops/tensor.py``:
``_plus``/``elemwise_add`` (``:124-143``), ``identity`` (``:76``),
``clip`` (``:112``), the broadcast binary family (``:180-194``),
``Reshape`` with the reference's special codes (``:268-309``),
``Flatten`` (``:311``), ``transpose`` (``:314``), ``slice_axis``
(``:375-390``) and ``SwapAxis`` (``:416-418``).
"""
from __future__ import annotations

import torch

from .registry import alias, register_simple

register_simple('identity', lambda x: x)
register_simple('_plus', torch.add, ninputs=2)
alias('elemwise_add', '_plus')
alias('_grad_add', '_plus')


def _clip(x, a_min=None, a_max=None):
    # jnp.clip is maximum-then-minimum: ties split the gradient 0.5/0.5
    if a_min is not None:
        x = torch.maximum(x, x.new_tensor(float(a_min)))
    if a_max is not None:
        x = torch.minimum(x, x.new_tensor(float(a_max)))
    return x


register_simple('clip', _clip, attr_defaults={'a_min': None, 'a_max': None})


def _compare(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


for _name, _fn in [
        ('broadcast_add', torch.add), ('broadcast_plus', torch.add),
        ('broadcast_sub', torch.sub), ('broadcast_minus', torch.sub),
        ('broadcast_mul', torch.mul), ('broadcast_div', torch.div),
        # jnp.mod takes the divisor's sign, as torch.remainder does
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

register_simple('transpose', lambda x, axes=(): x.permute(
    tuple(axes) if axes else tuple(range(x.ndim - 1, -1, -1))),
    attr_defaults={'axes': ()})


def _slice_axis(x, axis=0, begin=0, end=None):
    axis = int(axis) % x.ndim
    size = x.shape[axis]
    b = int(begin)
    e = size if end is None else int(end)
    if b < 0:
        b += size
    if e < 0:
        e += size
    return x.narrow(axis, b, e - b)


register_simple('slice_axis', _slice_axis,
                attr_defaults={'axis': 0, 'begin': 0, 'end': None})

register_simple('SwapAxis', lambda x, dim1=0, dim2=0: x.transpose(
    int(dim1), int(dim2)), attr_defaults={'dim1': 0, 'dim2': 0})
alias('swapaxes', 'SwapAxis')
