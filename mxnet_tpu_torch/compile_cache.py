"""Whole-step capture, batch signatures and the pow2 shape policy; the
port of ``mxnet_tpu/compile_cache.py`` (``fingerprint :161``,
``warm_start :341``, ``pad_to_bucket :365``, ``sig_key``/``batch_sig
:378-397``).

The JAX package compiles each fused step, and each served bucket, into
one XLA program, AOT-warmed and looked up by :func:`batch_sig`.  Here the
counterpart is :class:`CapturedStep`: one ``torch.cuda.CUDAGraph`` of a
step body that reads and writes only fixed buffers (batch, lr tensor,
parameters, aux, optimizer state, metric accumulators), recorded once
per (bucket, batch signature) and replayed.  A replay launches the same
hand-written kernels as the eager step, without the host's per-op work.

Capture is decided by a rule, before any attempt (:func:`capture_skip_reason`):
a step stays eager on the CPU, under ``NaiveEngine``, when its graph has
a ``Custom`` node (user Python runs every step), when it draws random
numbers and this PyTorch cannot register a generator with a graph, and
when it draws random numbers under ``MXNET_BACKWARD_DO_MIRROR`` (the
recompute replays the generator's state, which a capture cannot read); a
monitored module's step stays eager too (``Module.install_monitor``); the
caller keeps eager paths of its own for collectives (the sp step) and
``make_train_step(donate=False)``.  Each such choice counts
``compile.capture_skipped`` and logs its reason.  A capture that fails
raises; nothing falls back to the eager step.

Counters, as in the reference: a capture counts ``compile.traces`` and
its host seconds ``compile.warmup_secs``; a replay ``executor.cache_hits``.
The goodput ledger (``iowatch``) charges each recording to its
``compile`` bucket.
The kernel launches and ``instrument`` counters the body counts while it
is recorded (``instrument.recording``, on the capturing thread and on
the autograd thread that runs its backward) are
applied on each replay instead, so launches per step mean the same
captured or eager.

Captures and their eager warm-ups run one at a time process-wide, on
one stream per device that only capture code holds
(:func:`capture_stream`), so a serving replica's replays and the feed's
copies, each on a stream of its own, never land in a graph being
recorded.  Cached device memory is given back only through
:func:`release_memory`, which waits for any capture under way.

The persistent cache and the warmup manifest of the reference
(``mxnet_tpu/compile_cache.py:85-300``) are not ported.
"""
from __future__ import annotations

import gc
import hashlib
import logging
import threading
import time

import torch

from . import config, engine, instrument, iowatch
from .base import MXNetError

__all__ = ['pad_to_bucket', 'sig_key', 'batch_sig', 'fingerprint',
           'warm_start', 'capture_skip_reason', 'random_nodes',
           'CapturedStep', 'snapshot', 'step_tensors', 'capture_stream',
           'release_memory']

# ops that draw from the device generator: name -> does this node draw
_DRAWS = {
    'Dropout': lambda a, train: train and float(a.get('p', 0.5)) > 0,
    'LeakyReLU': lambda a, train: train and a.get('act_type') == 'rrelu',
    '_random_uniform': lambda a, train: True,
    '_random_normal': lambda a, train: True,
}


def pad_to_bucket(n, minimum=1):
    """Smallest power of two >= ``n`` (and >= ``minimum``)."""
    n = max(int(n), int(minimum), 1)
    return 1 << (n - 1).bit_length()


def _dtype_name(dtype):
    """numpy's name of a dtype ('float32', 'int32', 'bfloat16'), so a key
    here equals the JAX package's for the same batch."""
    return str(dtype).replace('torch.', '')


def sig_key(shapes_map, mesh=None):
    """Hashable key of a ``{name: (shape, dtype_str)}`` signature."""
    key = tuple(sorted((str(k), tuple(int(d) for d in s), str(dt))
                       for k, (s, dt) in shapes_map.items()))
    if mesh is not None:
        key = key + (('__mesh__', str(mesh)),)
    return key


def batch_sig(batch, mesh=None):
    """:func:`sig_key` of a placed batch ``{name: tensor}`` — the key of
    a module's captured steps."""
    return sig_key({k: (tuple(v.shape), _dtype_name(v.dtype))
                    for k, v in batch.items()}, mesh=mesh)


def fingerprint(symbol):
    """Stable identity of a Symbol's computation (sha1 of its JSON)."""
    fp = getattr(symbol, '_compile_cache_fp', None)
    if fp is None:
        fp = hashlib.sha1(symbol.tojson().encode()).hexdigest()[:16]
        symbol._compile_cache_fp = fp
    return fp


def warm_start(module, eval_metric=None, data_iter=None):
    """Entry point of ``fit(warm_start=True)``: the module's
    ``_warm_start`` hook (``Module``, ``BucketingModule``) with the batch
    signature ``data_iter`` provides (its ``provide_data`` and
    ``provide_label``, float32 as the bound arrays are).  On the card
    the hook captures the step for it before the first batch.  Modules
    without the hook warm nothing."""
    hook = getattr(module, '_warm_start', None)
    if hook is None:
        return
    sig = None
    if data_iter is not None:
        try:
            descs = list(data_iter.provide_data or []) + \
                list(data_iter.provide_label or [])
            sig = sig_key({n: (s, 'float32') for n, s in descs})
        except (AttributeError, TypeError, ValueError):
            sig = None
    hook(eval_metric, data_sig=sig)


# ---------------------------------------------------------------------------
# Whole-step capture
# ---------------------------------------------------------------------------

def random_nodes(program, is_train=True):
    """Names of the nodes of ``program`` that draw random numbers."""
    return [n.name for n in program.topo_nodes() if not n.is_variable
            and n.op in _DRAWS and _DRAWS[n.op](n.attrs, is_train)]


def _graph_generators():
    return hasattr(torch.cuda.CUDAGraph, 'register_generator_state')


def capture_skip_reason(device, program=None, is_train=True):
    """Why a step on ``device`` running ``program`` stays eager, or None
    when it is captured: 'NaiveEngine', 'cpu', 'Custom' (a graph with a
    Custom node runs user Python every step), 'random' (a node draws
    random numbers and this PyTorch cannot register the device generator
    with a graph) or 'random under the mirror' (a node draws random
    numbers in a training step under ``MXNET_BACKWARD_DO_MIRROR``)."""
    if not engine.capture_enabled():
        return 'NaiveEngine'
    if torch.device(device).type != 'cuda':
        return 'cpu'
    if program is not None:
        if any(n.op == 'Custom' for n in program.topo_nodes()):
            return 'Custom'
        if random_nodes(program, is_train):
            if not _graph_generators():
                return 'random'
            if is_train and config.get('MXNET_BACKWARD_DO_MIRROR'):
                return 'random under the mirror'
    return None


def note_skip(name, reason):
    """Count and log a step that stays eager by rule."""
    instrument.inc('compile.capture_skipped')
    logging.getLogger(__name__).info('%s stays eager: %s', name, reason)


def step_tensors(*trees):
    """The tensors of ``trees`` (dicts, lists, tensors; None skipped), in
    order: what a captured step is recorded over."""
    out = []
    for t in trees:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            out.extend(step_tensors(*t.values()))
        elif isinstance(t, (list, tuple)):
            out.extend(step_tensors(*t))
    return out


def snapshot(tensors, generators=()):
    """Copies of ``tensors`` (and generator states); returns a function
    that writes them back in place."""
    saved = [(t, t.detach().clone()) for t in tensors]
    states = [(g, g.get_state()) for g in generators]

    def restore():
        with torch.no_grad():
            for t, c in saved:
                t.copy_(c)
        for g, s in states:
            g.set_state(s)
    return restore


# Captures, their eager warm-ups and releases of cached device memory
# never run at once, process-wide: the caching allocator cannot release
# blocks while a graph is recorded (``torch.cuda.graph`` empties the
# cache as it starts), and every capture shares its device's one stream.
_capture_lock = threading.RLock()
_capture_streams = {}           # device index -> the capture stream


def capture_stream(device):
    """The stream every capture, and its eager warm-up, on ``device``
    runs on: made once per device, outside PyTorch's stream pool.
    ``torch.cuda.Stream()`` deals out a small pool round-robin, so a
    pooled capture stream can be another thread's current stream (a
    serving replica's, the feed's), whose work would then land in the
    graph being recorded ("Cannot prepare for replay during capturing
    stage").  Callers hold the capture lock."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _capture_streams.get(index)
    if stream is None:
        import ctypes
        lib = ctypes.CDLL('libcuda.so.1')
        lib.cuStreamCreate.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.c_uint]
        lib.cuStreamCreate.restype = ctypes.c_int
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            # a runtime call makes the device's primary context current
            # on this thread: the driver call creates the stream there
            torch.cuda.current_stream().query()
            err = lib.cuStreamCreate(ctypes.byref(handle), 1)  # NON_BLOCKING
        if err:
            raise MXNetError('cuStreamCreate failed (CUDA driver error %d)'
                             % err)
        stream = _capture_streams[index] = torch.cuda.ExternalStream(
            handle.value, device=torch.device('cuda', index))
    return stream


def _own_blas_workspace():
    """Drop cuBLAS's cached workspaces (one per handle and stream) before
    a warm-up or capture on the capture stream.  Kept, every graph one
    thread records there would bake in the same workspace, and replicas
    replaying such graphs at once would race on it; dropped, the next
    cuBLAS call allocates one, inside the graph's own pool when
    capturing.  Callers hold the capture lock."""
    torch._C._cuda_clearCublasWorkspaces()


def release_memory():
    """Give the card back the cached memory no live tensor holds (the
    pools of dropped graphs too), after any capture under way."""
    if not torch.cuda.is_initialized():
        return
    gc.collect()
    with _capture_lock:
        torch.cuda.empty_cache()


class CapturedStep(object):
    """One step over fixed buffers, replayed from a CUDA graph.

    ``body()`` runs the step on buffers it reads and writes in place and
    returns its outputs; ``bindings`` are the tensors it was built over
    (:meth:`holds` tells a caller whether they are still the ones it
    holds: a graph keeps raw addresses, the sm90 kernels' TMA tensor
    maps included).  ``skip`` is :func:`capture_skip_reason`'s answer:
    with a reason the step only ever runs eagerly.

    :meth:`run` is a fit step: the first call runs the body eagerly on
    the capture stream — a real step that is also the warm-up —
    and then records the graph (recording runs no kernel); later calls
    replay it.  Before any real step (a warm start) the caller runs
    :meth:`warm_up` inside :func:`snapshot` / restore, then
    :meth:`capture`.

    Graphs of one module share a memory ``pool`` (they replay on one
    stream, never at once; each serving replica's Predictor has its
    own).  A graph's temporaries may then lie under another graph's
    outputs, so with ``copy_outputs`` the body's outputs
    are copied into buffers allocated outside the pool, which no other
    graph's replay can touch.  Captures use ``capture_error_mode=
    'thread_local'``: the feed's worker and serving's client threads
    keep making CUDA calls while a graph is recorded."""

    def __init__(self, name, body, device, bindings=(), pool=None,
                 copy_outputs=False, skip=None, generators=()):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.bindings = list(bindings)
        self.pool = pool
        self.copy_outputs = copy_outputs
        self.skip = skip
        self.generators = list(generators)
        self.graph = None
        self.outputs = None
        self.capture_ms = None
        self.replays = 0
        self.launches = {}          # kernel name -> launches per replay
        self.cost = None            # perfwatch's accounting row, once made
        self.pool_bytes = None      # measured by capture(measure=True)
        self._counts = {}           # what one replay counts
        self._out_meta = None
        if skip is not None:
            note_skip(name, skip)

    @property
    def captured(self):
        return self.graph is not None

    def holds(self, tensors):
        """True when ``tensors`` are (identically) the tensors the step
        was built over."""
        return len(tensors) == len(self.bindings) and \
            all(a is b for a, b in zip(tensors, self.bindings))

    def warm_up(self):
        """Run the body once, eagerly: on the card on the capture stream
        (ordered after, and before, the current stream's work)."""
        if self.skip is not None:
            return self.body()
        with _capture_lock:
            s = capture_stream(self.device)
            cur = torch.cuda.current_stream(self.device)
            _own_blas_workspace()
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                outs = self.body()
            cur.wait_stream(s)
        self._out_meta = [(tuple(o.shape), o.dtype) for o in outs]
        return outs

    def capture(self, measure=False):
        """Record the graph (after a :meth:`warm_up`).  Raises on a
        failed capture, naming the graph node where the interpreter
        knows it.  With ``measure`` the bytes the device reserved for the
        graph's pool are kept in :attr:`pool_bytes` (the cache is emptied
        first, as the recording itself does on entry)."""
        if self.skip is not None:
            raise MXNetError('%s stays eager (%s); it is never captured'
                             % (self.name, self.skip))
        if self._out_meta is None:
            raise MXNetError('%s: warm_up() before capture()' % self.name)
        # the goodput ledger charges the recording to 'compile'
        with _capture_lock, iowatch.account('compile'):
            if measure:
                gc.collect()
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
            self._capture()
            if measure:
                self.pool_bytes = \
                    torch.cuda.memory_reserved(self.device) - reserved

    def _capture(self):
        t0 = time.perf_counter()
        ext = [torch.empty(s, dtype=d, device=self.device)
               for s, d in self._out_meta] if self.copy_outputs else None
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        _own_blas_workspace()
        err, outs = None, None
        try:
            with instrument.recording(capture=True) as self._counts, \
                    torch.cuda.graph(graph, pool=self.pool,
                                     stream=capture_stream(self.device),
                                     capture_error_mode='thread_local'):
                try:
                    outs = self.body()
                    if ext is not None:
                        for e, o in zip(ext, outs):
                            e.copy_(o)
                        outs = ext
                except Exception as e:             # noqa: BLE001
                    err = e
        except Exception:                          # noqa: BLE001
            if err is None:
                raise
        if err is not None:
            raise MXNetError('%s: CUDA graph capture failed: %s'
                             % (self.name, err)) from err
        self.graph = graph
        self.outputs = list(outs)
        for key, n in self._counts.items():
            if not isinstance(key, str):
                name = getattr(key[0], '__name__', str(key[0]))
                self.launches[name] = self.launches.get(name, 0) + n
        secs = time.perf_counter() - t0
        self.capture_ms = secs * 1e3
        instrument.inc('compile.traces')
        instrument.observe_hist('compile.warmup_secs', secs)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        instrument.apply_counts(self._counts)
        instrument.inc('executor.cache_hits')
        return self.outputs

    def run(self):
        """One step: the replay once captured, else the body (the first
        call on the card also records the graph)."""
        if self.graph is not None:
            return self.replay()
        outs = self.warm_up()
        if self.skip is None:
            self.capture()
        return outs
