"""Engine facade — synchronization and execution-mode control; the port
of ``mxnet_tpu/engine.py`` (``:1-176``).

PyTorch's CUDA streams execute in order, so, as in the JAX package, this
module only exposes the control surface users relied on:

- ``wait_for_var`` / ``wait_for_all`` and :func:`sync`;
- ``set_engine_type('NaiveEngine')`` — the ``MXNET_ENGINE_TYPE`` debug
  switch.  The JAX package disables jit under it; the port disables
  whole-step capture (``compile_cache.CapturedStep``), so every step and
  served forward runs eagerly, op by op, with a Python backtrace;
- :class:`StepWindow`, the fit loop's bound on in-flight steps;
- :class:`NativeEngine` (``mxnet_tpu/engine.py:179-335``), the host-side
  dependency engine over ``csrc/host/engine.cc`` (``_native.py``):
  versioned variables, ``push(fn, const_vars, mutable_vars)`` with
  reads concurrent and writes serialised, ``wait_for_var`` /
  ``wait_for_all``, a priority lane, a Chrome-trace profile.
  :func:`native_engine` is the process's one engine;
  ``io.PrefetchingIter`` pushes its fetches onto it.

Exit.  The reference's engine can deadlock at exit (its atexit hook
disposes the engine while a ``PrefetchingIter.__del__`` waits on it).
Here the one atexit hook (:func:`_shutdown_native_engine`) first stops
every ``PrefetchingIter`` (their pushed fetches then return at once) and
drains the engine for at most a few seconds, then tells the engine to
run no more callbacks and frees it; a fetch still inside Python after
the drain leaves the engine unfreed rather than joining a worker the
interpreter may never run again.  The trampoline enters no Python code
once shutdown has begun, and ``PrefetchingIter.__del__`` never waits on
the engine.
"""
from __future__ import annotations

import atexit
import ctypes
import sys
import threading
import traceback
from collections import deque

import torch

from . import config, instrument, iowatch, perfwatch

__all__ = ['set_engine_type', 'get_engine_type', 'capture_enabled', 'sync',
           'wait_for_var', 'wait_for_all', 'set_bulk_size', 'StepWindow',
           'Var', 'NativeEngine', 'native_engine']

_DEFAULT = 'ThreadedEnginePerDevice'
_engine_type = [_DEFAULT]


def set_engine_type(name: str):
    """``'NaiveEngine'`` => every step runs eagerly (no CUDA graphs) and
    the native engine runs each push on the pushing thread; anything
    else restores capture and the threaded engine.  Applies to steps and
    forwards built after the call; the native engine is rebuilt in the
    new mode (``mxnet_tpu/engine.py:27-38``)."""
    global _native_engine
    _engine_type[0] = str(name)
    old = _native_engine
    if old is not None and old.naive != (name == 'NaiveEngine'):
        _native_engine = None
        old.dispose()


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


# ---------------------------------------------------------------------------
# The native host-side dependency engine
# ---------------------------------------------------------------------------

_shutdown_begun = False


class Var(object):
    """A versioned variable of a :class:`NativeEngine`
    (``Engine::NewVariable``)."""
    __slots__ = ('handle', '_engine')

    def __init__(self, engine, handle):
        self._engine = engine
        self.handle = handle

    @property
    def version(self):
        """How many writes have completed on it."""
        self._engine._check_alive()
        return self._engine._lib.MXTPUTorchEngineVarVersion(
            self._engine._handle, self.handle)


class NativeEngine(object):
    """ctypes wrapper of the C++ dependency engine.

    ``push(fn, const_vars, mutable_vars)`` is ``Engine::PushAsync``
    (``include/mxnet/engine.h:104-129``): ``fn`` runs on a worker thread
    once every read and write it declares is granted; writes to a var
    are serialised in push order, reads run concurrently.  ``naive``
    runs each push on the pushing thread, at once.  An exception ``fn``
    raises is printed, never passed into the C worker."""

    def __init__(self, num_workers=None, naive=False):
        from ._native import ENGINE_CALLBACK, engine_lib
        if num_workers is None:
            num_workers = int(config.get('MXNET_CPU_WORKER_NTHREADS'))
        self._lib = engine_lib()
        self.naive = bool(naive)
        self._handle = self._lib.MXTPUTorchEngineCreate(int(num_workers),
                                                        int(self.naive))
        self._callbacks = {}
        self._next_id = 1
        self._cb_lock = threading.Lock()

        def trampoline(ctx):
            if _shutdown_begun:
                return
            with self._cb_lock:
                fn = self._callbacks.pop(int(ctx), None)
            if fn is None:
                return
            try:
                fn()
            except Exception:               # noqa: BLE001
                traceback.print_exc()
        # outlives every pending op: kept on the engine (and the engine
        # is kept alive while its workers may call it)
        self._trampoline = ENGINE_CALLBACK(trampoline)

    def _check_alive(self):
        if not self._handle:
            raise RuntimeError('native engine has been disposed '
                               '(set_engine_type rebuilds the global one; '
                               'take it again from native_engine())')

    @property
    def alive(self):
        return bool(self._handle)

    def new_var(self):
        self._check_alive()
        return Var(self, self._lib.MXTPUTorchEngineNewVar(self._handle))

    def del_var(self, var):
        """``Engine::DeleteVariable``: the var is freed once every op
        queued on it has completed; it must not be used after."""
        if self._handle and var.handle:
            self._lib.MXTPUTorchEngineDelVar(self._handle, var.handle)
            var.handle = None

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name='op'):
        """Run ``fn()`` once its dependencies are granted; ``priority``
        > 0 takes the prioritized lane.  Read and write sets must be
        disjoint and free of duplicates (the reference's
        ``CheckDuplicate``, ``threaded_engine.cc:207``)."""
        self._check_alive()
        handles = [v.handle for v in mutable_vars]
        if len(set(handles)) != len(handles) or \
                set(handles) & {v.handle for v in const_vars}:
            raise ValueError('const_vars and mutable_vars must be disjoint '
                             'and duplicate-free')
        with self._cb_lock:
            cb_id = self._next_id
            self._next_id += 1
            self._callbacks[cb_id] = fn
        nc, nm = len(const_vars), len(mutable_vars)
        carr = (ctypes.c_void_p * max(nc, 1))(*[v.handle for v in const_vars])
        marr = (ctypes.c_void_p * max(nm, 1))(*handles)
        self._lib.MXTPUTorchEnginePushAsync(
            self._handle, self._trampoline, ctypes.c_void_p(cb_id), carr, nc,
            marr, nm, int(priority), str(name).encode())

    @staticmethod
    def _ms(timeout):
        return -1 if timeout is None else max(0, int(timeout * 1000))

    def wait_for_var(self, var, timeout=None):
        """Wait (at most ``timeout`` seconds) until every op pushed on
        ``var`` so far has completed; True when they have."""
        self._check_alive()
        with instrument.span('engine.wait_for_var', cat='wait'):
            return bool(self._lib.MXTPUTorchEngineWaitForVar(
                self._handle, var.handle, self._ms(timeout)))

    def wait_for_all(self, timeout=None):
        """Wait (at most ``timeout`` seconds) until no op is pending;
        True when none is."""
        self._check_alive()
        with instrument.span('engine.wait_for_all', cat='wait'):
            return bool(self._lib.MXTPUTorchEngineWaitForAll(
                self._handle, self._ms(timeout)))

    def set_profiling(self, on):
        self._check_alive()
        self._lib.MXTPUTorchEngineSetProfiling(self._handle, int(bool(on)))

    def dump_profile(self, path):
        """Write the profiled ops as a Chrome trace (``traceEvents``)."""
        self._check_alive()
        if self._lib.MXTPUTorchEngineDumpProfile(self._handle,
                                                 str(path).encode()):
            raise IOError('cannot write the engine profile to %s' % path)

    def stop_callbacks(self):
        """From now on no pushed function runs (their dependencies still
        complete): the engine enters no Python code any more."""
        if self._handle:
            self._lib.MXTPUTorchEngineShutdown(self._handle)

    def dispose(self):
        """Drain the pending ops and free the engine (its worker threads
        joined)."""
        handle, self._handle = self._handle, None
        if handle:
            self._lib.MXTPUTorchEngineFree(handle)

    def __del__(self):
        # never joins threads while the interpreter is being torn down
        if sys.is_finalizing():
            return
        try:
            self.dispose()
        except Exception:                   # noqa: BLE001
            pass


_native_engine = None
_native_lock = threading.Lock()
_atexit_registered = False
_kept = []          # engines left unfreed at exit (their workers may call)
SHUTDOWN_DRAIN_SECS = 5.0


def native_engine():
    """The process's host-side engine (``Engine::Get()``), made at the
    first call in the mode :func:`get_engine_type` says."""
    global _native_engine, _atexit_registered
    with _native_lock:
        if _native_engine is None:
            _native_engine = NativeEngine(naive=not capture_enabled())
            if not _atexit_registered:
                atexit.register(_shutdown_native_engine)
                _atexit_registered = True
        return _native_engine


def _shutdown_native_engine(drain_secs=None):
    """At exit: stop every ``PrefetchingIter`` and drain the engine for at
    most ``drain_secs``, then stop its callbacks and free it (or, when a
    callback is still inside Python, keep it unfreed: joining that worker
    could wait on an interpreter that no longer runs it)."""
    global _native_engine, _shutdown_begun
    io_mod = sys.modules.get(__name__.rsplit('.', 1)[0] + '.io')
    if io_mod is not None:
        io_mod._stop_prefetchers()
    with _native_lock:
        eng, _native_engine = _native_engine, None
    if eng is None or not eng.alive:
        _shutdown_begun = True
        return
    drained = eng.wait_for_all(SHUTDOWN_DRAIN_SECS if drain_secs is None
                               else drain_secs)
    _shutdown_begun = True
    eng.stop_callbacks()
    if drained:
        eng.dispose()
    else:
        _kept.append(eng)
