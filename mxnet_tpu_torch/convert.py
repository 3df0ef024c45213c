"""Weights carried across from the JAX package.

:func:`params_from_numpy` takes the JAX package's parameters as numpy
arrays (what ``mx.nd.load`` or ``arg.asnumpy()`` give there) and returns
the dict the port's :class:`~mxnet_tpu_torch.predictor.Predictor` and
``ModelServer.load_model`` take.  :func:`load_params` reads a
``.params`` file written by either package (same container format), and
:func:`random_params` makes seeded numpy weights for a symbol, for runs
that need no checkpoint.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from .context import Context

__all__ = ['params_from_numpy', 'random_params', 'load_params']


def _context(device):
    if device is None or isinstance(device, Context):
        return device or Context('gpu', 0)
    dev = torch.device(device)
    return Context('gpu' if dev.type == 'cuda' else dev.type,
                   dev.index or 0)


def params_from_numpy(arg_params, aux_params=None, device=None):
    """``{'arg:name': NDArray, 'aux:name': NDArray}`` on ``device`` (a
    ``torch.device``, a device string or a Context; default ``cuda:0``)
    from name -> numpy array dicts.  float64 arrays become float32, as
    ``nd.array`` does in both packages."""
    ctx = _context(device)
    out = {'arg:%s' % k: nd.array(v, ctx) for k, v in arg_params.items()}
    out.update({'aux:%s' % k: nd.array(v, ctx)
                for k, v in (aux_params or {}).items()})
    return out


def random_params(symbol, input_shapes, seed, init='he'):
    """Random ``(arg_params, aux_params)`` numpy dicts for ``symbol`` at
    ``input_shapes``, from a numpy seed — the same arrays can be fed to
    both packages.  Inputs named in ``input_shapes`` and ``*_label``
    arguments get none.

    ``init='he'`` (ResNet): weights He-scaled (the last conv of each
    residual branch, ``*_conv3_weight``, at 0.2 of that so stacked
    residual units do not double the activation variance each), gammas
    and moving variances in [0.5, 1.5), betas, biases and moving means
    ~ N(0, 0.1²).  ``init='normal'`` (the transformer LM): every argument
    ~ N(0, 0.02²) from ``np.random.RandomState(seed)`` in
    ``list_arguments`` order, the draws of the JAX package's
    transformer-LM bench leg (``bench.py:974-978``)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    arg, aux = {}, {}
    if init == 'normal':
        rs = np.random.RandomState(seed)
        for name, shp in zip(symbol.list_arguments(), arg_shapes):
            if name not in input_shapes and not name.endswith('label'):
                arg[name] = rs.normal(0, 0.02, shp).astype(np.float32)
        if aux_shapes:
            raise ValueError("init='normal' draws no auxiliary states; %s "
                             'has %d' % (symbol.name, len(aux_shapes)))
        return arg, aux
    if init != 'he':
        raise ValueError("init must be 'he' or 'normal', got %r" % (init,))
    r = np.random.default_rng(seed)
    for name, shp in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes or name.endswith('label'):
            continue
        if name.endswith('weight'):
            gain = 0.2 if name.endswith('_conv3_weight') else 1.0
            std = gain * np.sqrt(2.0 / np.prod(shp[1:]))
            arg[name] = r.standard_normal(shp, dtype=np.float32) \
                * np.float32(std)
        elif name.endswith('gamma'):
            arg[name] = r.random(shp, dtype=np.float32) + np.float32(0.5)
        else:
            arg[name] = r.standard_normal(shp, dtype=np.float32) \
                * np.float32(0.1)
    for name, shp in zip(symbol.list_auxiliary_states(), aux_shapes):
        if name.endswith('moving_var'):
            aux[name] = r.random(shp, dtype=np.float32) + np.float32(0.5)
        else:
            aux[name] = r.standard_normal(shp, dtype=np.float32) \
                * np.float32(0.1)
    return arg, aux


def load_params(path, device='cpu'):
    """The ``{key: NDArray}`` dict of a ``.params`` file (keys keep their
    ``arg:``/``aux:`` prefixes), placed on ``device``."""
    params = nd.load(path, _context(device))
    if not isinstance(params, dict):
        raise ValueError('%s holds an unnamed array list, not parameters'
                         % path)
    return params
