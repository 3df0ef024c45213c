"""Engine facade — synchronization and execution-mode control; the port
of ``mxnet_tpu/engine.py`` (``:1-176``).

PyTorch's CUDA streams execute in order, so, as in the JAX package, this
module only exposes the control surface users relied on:

- ``wait_for_var`` / ``wait_for_all`` and :func:`sync`;
- ``set_engine_type('NaiveEngine')`` — the ``MXNET_ENGINE_TYPE`` debug
  switch.  The JAX package disables jit under it; the port disables
  whole-step capture (``compile_cache.CapturedStep``), so every step and
  served forward runs eagerly, op by op, with a Python backtrace;
- :class:`StepWindow`, the fit loop's bound on in-flight steps.

The native threaded dependency engine (``NativeEngine``) is not ported.
"""
from __future__ import annotations

from collections import deque

import torch

from . import instrument, iowatch, perfwatch

__all__ = ['set_engine_type', 'get_engine_type', 'capture_enabled', 'sync',
           'wait_for_var', 'wait_for_all', 'set_bulk_size', 'StepWindow']

_DEFAULT = 'ThreadedEnginePerDevice'
_engine_type = [_DEFAULT]


def set_engine_type(name: str):
    """``'NaiveEngine'`` => every step runs eagerly (no CUDA graphs);
    anything else restores capture.  Applies to steps and forwards
    built after the call."""
    _engine_type[0] = str(name)


def get_engine_type() -> str:
    return _engine_type[0]


def capture_enabled() -> bool:
    return _engine_type[0] != 'NaiveEngine'


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [getattr(tree, 'handle', tree)]


def sync(tree=None):
    """Wait until the device has computed every tensor (or NDArray) in
    ``tree`` — a synchronise of each card they lie on; CPU tensors need
    none.  With ``tree`` None, every card with work queued.  Returns
    ``tree``."""
    devices = {t.device for t in _leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    if tree is None and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        devices = {torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


def wait_for_var(array):
    array.wait_to_read()


def wait_for_all():
    from .ndarray import waitall
    waitall()


def set_bulk_size(size):
    """Engine op bulking knob — kept as a no-op for API parity
    (``MXEngineSetBulkSize``)."""
    return size


class StepWindow(object):
    """Bounded window of in-flight training steps
    (``mxnet_tpu/engine.py:88``).

    Launching a step returns before the device runs it, so without a
    bound the fit loop could queue any number of steps ahead of the
    card.  After launching step N the loop ``admit``\\s a *ticket*; once
    ``depth`` tickets are in flight the oldest is waited on before the
    loop goes on.  ``depth=1`` is fully synchronous stepping; ``depth=2``
    (the ``MXTPU_ASYNC_DEPTH`` default) lets the host launch step N+1
    while the device runs step N.  A ticket is a ``torch.cuda.Event``
    recorded after the step (the wait synchronises on it) or anything
    else — CPU tensors — on which the wait does nothing.

    The in-flight count is the ``engine.inflight_depth`` gauge, its high
    mark ``engine.inflight_peak``, and each wait counts
    ``engine.window_waits``."""

    def __init__(self, depth):
        self.depth = max(1, int(depth))
        self._inflight = deque()
        self._peak = 0

    @staticmethod
    def _wait(ticket):
        # iowatch.stage.window_wait is the device-bound signal: a fat
        # window_wait with a thin feed_wait means the card is the
        # bottleneck; the wait stays in the goodput ledger's productive
        # remainder (the card is training).  Host-timed: the wait is
        # the host's.
        with perfwatch.phase('window_wait'), \
                iowatch.stage('window_wait'):
            instrument.inc('engine.window_waits')
            if isinstance(ticket, torch.cuda.Event):
                ticket.synchronize()

    def admit(self, ticket):
        """Register a just-launched step; blocks (on the OLDEST step)
        until at most ``depth - 1`` remain in flight."""
        if ticket is None:
            return
        self._inflight.append(ticket)
        n = len(self._inflight)
        if n > self._peak:
            self._peak = n
            instrument.set_gauge('engine.inflight_peak', n)
        instrument.set_gauge('engine.inflight_depth', n)
        while len(self._inflight) >= self.depth:
            self._wait(self._inflight.popleft())
            instrument.set_gauge('engine.inflight_depth',
                                 len(self._inflight))

    def drain(self):
        """Wait out every in-flight step (epoch boundaries)."""
        while self._inflight:
            self._wait(self._inflight.popleft())
        instrument.set_gauge('engine.inflight_depth', 0)
