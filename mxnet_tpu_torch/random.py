"""Random sampling — the port of ``mxnet_tpu/random.py``.

The JAX package threads one process-global functional PRNG key.  Here
each device has its own explicit ``torch.Generator``, created on first
use and seeded from the process seed; nothing draws from torch's global
RNG.  :func:`uniform` and :func:`normal` are the imperative samplers of
the reference (``shape=``, ``ctx=``, ``out=``, ``mxnet_tpu/random.py:
20-31``), through the ``_random_uniform`` / ``_random_normal`` ops.  The
two packages give different numbers from the same seed: tests that
compare them make their inputs with numpy, and compare only moments of
the samplers.
"""
from __future__ import annotations

import torch

__all__ = ['seed', 'generator', 'uniform', 'normal']

_SEED = [0]
_GENERATORS = {}     # torch.device -> torch.Generator


def seed(seed_state):
    """Seed every device's generator (reference ``random.seed`` /
    ``MXRandomSeed``); generators made later start from it too."""
    if not isinstance(seed_state, int):
        raise ValueError('seed_state must be an integer')
    _SEED[0] = seed_state
    for g in _GENERATORS.values():
        g.manual_seed(seed_state)


def generator(device):
    """The ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    g = _GENERATORS.get(device)
    if g is None:
        g = _GENERATORS[device] = torch.Generator(device=device)
        g.manual_seed(_SEED[0])
    return g


def _sample(op, a, b, shape, ctx, out):
    from .ndarray import imperative_invoke
    kw = {}
    if out is not None:
        shape = out.shape if shape is None else shape
        ctx = out.context if ctx is None else ctx
        kw['dtype'] = out.dtype
    return imperative_invoke(op, a, b, shape=tuple(shape), ctx=ctx, out=out,
                             **kw)


def uniform(low=0.0, high=1.0, shape=None, ctx=None, out=None):
    """U(low, high) samples of ``shape`` on ``ctx`` (default the ``with``
    scope's context, else ``gpu(0)``), or into ``out`` (its shape, device
    and dtype)."""
    return _sample('_random_uniform', low, high, shape, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, ctx=None, out=None):
    """N(loc, scale^2) samples of ``shape`` on ``ctx`` (default the
    ``with`` scope's context, else ``gpu(0)``), or into ``out`` (its shape,
    device and dtype)."""
    return _sample('_random_normal', loc, scale, shape, ctx, out)
