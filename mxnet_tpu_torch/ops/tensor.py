"""Tensor operators the ResNet serving path needs.

The port of the matching entries of ``mxnet_tpu/ops/tensor.py``:
``_plus``/``elemwise_add`` (``:124-143``), ``identity`` (``:76``),
``Reshape`` with the reference's special codes (``:268-309``),
``Flatten`` (``:311``) and ``transpose`` (``:314``).
"""
from __future__ import annotations

import torch

from .registry import alias, register_simple

register_simple('identity', lambda x: x)
register_simple('_plus', torch.add, ninputs=2)
alias('elemwise_add', '_plus')
alias('_grad_add', '_plus')


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
