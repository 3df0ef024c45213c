"""Random sampling — the port of ``mxnet_tpu/random.py``.

The JAX package threads one process-global functional PRNG key.  Here
each device has its own explicit ``torch.Generator``, created on first
use and seeded from the process seed; nothing draws from torch's global
RNG.  The two packages give different numbers from the same seed: tests
that compare them make their inputs with numpy.
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


def uniform(low, high, out):
    """U(low, high) samples into the NDArray ``out``, from its device's
    generator."""
    t = torch.empty(out.shape, dtype=out.dtype, device=out.handle.device)
    out._set_data(t.uniform_(low, high, generator=generator(t.device)))
    return out


def normal(loc, scale, out):
    """N(loc, scale^2) samples into the NDArray ``out``, from its
    device's generator."""
    t = torch.empty(out.shape, dtype=out.dtype, device=out.handle.device)
    out._set_data(t.normal_(loc, scale, generator=generator(t.device)))
    return out
