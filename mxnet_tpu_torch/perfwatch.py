"""Performance-attribution plane — live MFU, step phases, a memory
ledger, OOM forensics; the port of ``mxnet_tpu/perfwatch.py``.

1. **Per-signature accounting** — the reference reads ``cost_analysis()``
   / ``memory_analysis()`` from each AOT-compiled XLA executable.  A
   captured CUDA graph has no such analysis, so the FLOPs of a step are
   COUNTED over its eager warm-up, the real step that precedes the
   capture (never inside the capture): ``torch.utils.flop_counter.
   FlopCounterMode`` counts the aten ops (the plain backwards, cuDNN and
   cuBLAS calls), and each hand-written kernel's wrapper adds its own
   analytic count (:func:`note_kernel_flops`; FlopCounterMode cannot see
   into a ctypes launch), the count FlopCounterMode gives the kernel's
   plain version.  :func:`register_executable` publishes the row as
   ``xla.<kind>[<key>].*`` gauges (the reference's names) and keeps it in
   :func:`executables`.  Bytes accessed are not counted (0).

2. **Live MFU and phases** — :func:`note_step` derives ``perf.mfu``
   (the signature's FLOPs × steps/sec over the card's peak:
   ``MXTPU_PEAK_FLOPS``, else :data:`PEAKS` by
   ``torch.cuda.get_device_name``) and ``perf.steps_per_sec`` from a
   rolling window.  :func:`phase` attributes a region to
   ``perf.phase.<name>``: on the card by a pair of CUDA events recorded
   on the current stream, outside any graph, read back (without a host
   sync) at the next metric drain (:func:`harvest`); on the CPU by the
   host clock.  ``MXTPU_STEP_SAMPLE=N`` fully syncs every Nth step
   (``perf.step_latency``, ``perf.host_syncs``, a ``perf.step`` span);
   ``metric.host_syncs`` is untouched.

3. **Memory ledger** — :func:`ledger_alloc` / :func:`ledger_donate`
   account allocations by site into ``mem.live_bytes`` /
   ``mem.peak_bytes`` with per-site attribution (:func:`ledger_top`); the
   card's own totals come from ``torch.cuda`` (``mem.device_*`` gauges,
   :func:`ledger_stats`).  A captured graph's pool is not attributable
   tensor by tensor: each captured signature is ONE ledger entry, the
   reserved bytes its capture added (site ``graph_pool``).

4. **OOM forensics** — :func:`on_error` turns a
   ``torch.cuda.OutOfMemoryError`` into a flight-recorder dump carrying
   the signature's row, the largest ledger entries and the current
   MFU/phase picture.

Under a dp×tp mesh a row's ``flops`` are one rank's (its rows of the
batch) and ``global_flops`` that times ``num_devices`` (dp·tp), and
``perf.mfu`` divides by ``num_devices`` times the card's peak: a per-card
fraction (the tp peers of a rank run the same arithmetic, so global
FLOPs count it tp times; ROADMAP Queue 3).

Off by default: every hook is one module-global check, no event is
recorded and nothing counted.  ``MXTPU_PERFWATCH=1`` implies the metrics
registry.  The communication plane (``commwatch.py``) hooks in through
``_comm``: :func:`activate_fit` re-reads its knob and :func:`note_step`
hands it each step's interval and per-device FLOPs.
"""
from __future__ import annotations

import hashlib
import threading
import time
import weakref
from collections import deque

import torch

from . import config, instrument

__all__ = [
    'enabled', 'set_enabled', 'refresh', 'activate_fit', 'capture_on',
    'count_flops', 'note_kernel_flops', 'analytic_step_flops',
    'register_executable', 'executables', 'executable_info',
    'clear_executables',
    'PEAKS', 'DEFAULT_PEAK_KEY', 'device_peaks', 'peaks', 'peak_flops',
    'mfu', 'roofline_mandatory',
    'note_step', 'phase', 'harvest', 'sample_tick', 'sample_sync',
    'ledger_alloc', 'ledger_donate', 'ledger_top', 'ledger_stats',
    'ledger_reset',
    'on_error', 'is_oom', 'forensics_snapshot',
]

# (peak bf16 dense FLOP/s, peak HBM bytes/s) by the name
# torch.cuda.get_device_name gives: the H100 SXM datasheet's 989 TFLOP/s
# dense bf16 and 3.35 TB/s.  The CPU entry is a nominal host figure so
# MFU stays defined (not meaningful) in CPU tests.
PEAKS = {
    'NVIDIA H100 80GB HBM3': (989e12, 3.35e12),
    'cpu': (2e11, 1e11),
}
DEFAULT_PEAK_KEY = 'NVIDIA H100 80GB HBM3'

_on = False
_sample_n = 0
_peaks = None              # (flops, bw) once resolved on the card
_lock = threading.Lock()

# the communication plane (commwatch.py) sets _comm to its module at
# import and mirrors its enablement into _comm_on, a plain bool, so the
# hot path's off check is one global read
_comm = None
_comm_on = False

# rolling window of step-dispatch monotonic timestamps
_step_window = deque(maxlen=64)
_sample_count = 0

# (kind, keystr) -> row
_executables = {}


# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------

def refresh():
    """(Re)read MXTPU_PERFWATCH / MXTPU_STEP_SAMPLE.  Called at import and
    from :func:`activate_fit`; hot-path hooks read the module globals."""
    global _on, _sample_n
    _on = bool(config.get('MXTPU_PERFWATCH'))
    _sample_n = max(0, int(config.get('MXTPU_STEP_SAMPLE')))
    if _on and not instrument.metrics_enabled():
        instrument.set_metrics(True)


def set_enabled(on):
    """Runtime toggle (tests; equivalent to exporting MXTPU_PERFWATCH)."""
    global _on
    _on = bool(on)
    if _on and not instrument.metrics_enabled():
        instrument.set_metrics(True)


def enabled():
    return _on


def capture_on():
    """True when a plane needs the per-signature accounting and
    :func:`note_step` (this plane; the communication plane once
    ported)."""
    return _on or _comm_on


def activate_fit():
    """Called by ``BaseModule.fit`` before the first batch: re-read the
    knobs and reset the sampling cadence and the steps/sec window."""
    global _sample_count
    if _comm is not None:
        _comm.activate_fit()
    refresh()
    if not _on and not _comm_on:
        return
    _sample_count = 0
    # the comm plane's step intervals must not span fits either
    _step_window.clear()
    instrument.set_gauge('perf.peak_flops', peaks()[0])


# ---------------------------------------------------------------------------
# Leg 1: FLOPs of a step, per signature
# ---------------------------------------------------------------------------

_kernel_sink = None        # the count_flops region under way, or None


class _FlopCount(object):
    """FlopCounterMode over a region plus the analytic counts the kernel
    wrappers report inside it: ``aten_flops``, ``kernel_flops`` and their
    sum ``flops`` after the region."""

    def __init__(self):
        self.aten_flops = 0
        self.kernel_flops = 0
        self._mode = None
        self._prev = None

    @property
    def flops(self):
        return self.aten_flops + self.kernel_flops

    def __enter__(self):
        global _kernel_sink
        from torch.utils.flop_counter import FlopCounterMode
        self._mode = FlopCounterMode(display=False)
        self._prev, _kernel_sink = _kernel_sink, self
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _kernel_sink
        try:
            self._mode.__exit__(*exc)
        finally:
            _kernel_sink = self._prev
        self.aten_flops = int(self._mode.get_total_flops())
        return False


def count_flops():
    """Context manager counting the FLOPs of the region (see
    :class:`_FlopCount`)."""
    return _FlopCount()


def note_kernel_flops(n):
    """A hand-written kernel's analytic FLOPs for one launch, reported by
    its wrapper where it launches; counted only inside
    :func:`count_flops` (one global read otherwise)."""
    sink = _kernel_sink
    if sink is not None:
        sink.kernel_flops += int(n)


def analytic_step_flops(symbol, shapes, fixed=()):
    """The FLOPs of one training step of ``symbol`` counted from its
    convolutions and dots: for each ``Convolution`` and
    ``FullyConnected`` node, ``2 · numel(out) · prod(weight.shape[1:])``
    forward, the same again for the weight gradient (a trainable
    weight) and for the input gradient (an input that depends on a
    trainable parameter).  ``shapes`` are the data and label shapes;
    ``fixed`` names parameters that are not trained.  Other ops count 0,
    as FlopCounterMode counts them."""
    internals = symbol.get_internals()
    arg_shapes, out_shapes, _ = internals.infer_shape(**shapes)
    arg_shape = dict(zip(internals.list_arguments(), arg_shapes))
    out_shape = dict(zip(internals.list_outputs(), out_shapes))
    trained = set(arg_shape) - set(shapes) - set(fixed)
    needs_grad = {}
    total = 0
    for node in symbol.topo_nodes():
        if node.is_variable:
            needs_grad[node.name] = node.name in trained
            continue
        ins = [needs_grad.get(src.name, False) for src, _ in node.inputs]
        needs_grad[node.name] = any(ins)
        if node.op not in ('Convolution', 'FullyConnected'):
            continue
        w = node.inputs[1][0]
        out = out_shape[node.output_names()[0]]
        numel = 1
        for d in out:
            numel *= int(d)
        k = 1
        for d in arg_shape[w.name][1:]:
            k *= int(d)
        fwd = 2 * numel * k
        total += fwd * (1 + int(ins[1]) + int(ins[0]))
    return total


_keystr_memo = {}


def _keystr(key):
    """Stable short id of a signature (sig tuples are hashed: a gauge
    name must be bounded and Prometheus-safe).  Memoized."""
    try:
        cached = _keystr_memo.get(key)
    except TypeError:
        cached, hashable = None, False
    else:
        hashable = True
        if cached is not None:
            return cached
    s = key if isinstance(key, str) else repr(key)
    if len(s) <= 24 and s.replace('_', '').replace('-', '').isalnum():
        out = s
    else:
        out = hashlib.sha1(s.encode()).hexdigest()[:10]
    if hashable:
        if len(_keystr_memo) > 256:
            _keystr_memo.clear()
        _keystr_memo[key] = out
    return out


_FIELDS = ('flops', 'aten_flops', 'kernel_flops', 'bytes_accessed',
           'pool_bytes', 'num_devices', 'global_flops')


def manifest_flops(kind, key):
    """The FLOPs a previous process counted for this signature: the
    ``step_cost`` row of the warmup manifest
    (``compile_cache.record_entry``), or None."""
    from . import compile_cache
    if compile_cache.cache_dir() is None:
        return None
    k = _keystr(key)
    for e in compile_cache.manifest_entries('step_cost'):
        if e.get('program') == str(kind) and e.get('key') == k:
            return float(e['flops'])
    return None


def register_executable(kind, key, cost, num_devices=1, file=True):
    """Record one step signature's accounting: ``cost`` a dict with
    ``flops`` (and optionally ``aten_flops``, ``kernel_flops``,
    ``pool_bytes``).  Publishes ``xla.<kind>[<key>].*`` gauges and stores
    the row in :func:`executables`; with ``file`` (counted FLOPs) and a
    warmup manifest it files a ``step_cost`` row there (the reference's
    ``xla_cost`` row, ``mxnet_tpu/perfwatch.py:293``, less what the port
    does not count), from which a later process takes the FLOPs without
    counting them (:func:`manifest_flops`).  Never raises; returns the
    row, or None when metrics are off."""
    if not instrument.metrics_enabled():
        return None
    try:
        info = {'kind': str(kind), 'key': _keystr(key),
                'num_devices': max(1, int(num_devices)),
                'flops': 0.0, 'aten_flops': 0.0, 'kernel_flops': 0.0,
                'bytes_accessed': 0.0, 'pool_bytes': 0}
        info.update(cost or {})
        info['global_flops'] = info['flops'] * info['num_devices']
        with _lock:
            _executables[(info['kind'], info['key'])] = info
        stem = 'xla.%s[%s]' % (info['kind'], info['key'])
        for field in _FIELDS:
            instrument.set_gauge('%s.%s' % (stem, field), info[field])
        instrument.set_gauge('xla.executables', len(_executables))
        if file:
            from . import compile_cache
            compile_cache.record_entry({
                'kind': 'step_cost', 'program': info['kind'],
                'key': info['key'], 'flops': info['flops'],
                'num_devices': info['num_devices']})
        return info
    except Exception:        # noqa: BLE001 - accounting never raises
        return None


def executables():
    """Snapshot of every registered row."""
    with _lock:
        return [dict(v) for v in _executables.values()]


def executable_info(kind, key):
    with _lock:
        info = _executables.get((str(kind), _keystr(key)))
        return dict(info) if info else None


def clear_executables():
    with _lock:
        _executables.clear()


# ---------------------------------------------------------------------------
# Leg 2a: MFU
# ---------------------------------------------------------------------------

_warned_fallback_peaks = False


def _live_device_kind(device=None):
    """The name of the card the run is on (``device``, else the current
    card once CUDA is initialized; never initializes it), or 'cpu'."""
    if device is not None:
        device = torch.device(device)
        if device.type != 'cuda':
            return 'cpu'
        return torch.cuda.get_device_name(device)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return 'cpu'


def device_peaks(kind=None):
    """(peak flops/sec, peak HBM bytes/sec) for a card name (probed when
    None).  A name not in :data:`PEAKS` falls back to the H100's, with
    one warning: an MFU against the wrong peak must not be silently
    wrong (set MXTPU_PEAK_FLOPS to pin the denominator)."""
    global _warned_fallback_peaks
    if kind is None:
        kind = _live_device_kind()
    for key, pk in PEAKS.items():
        if str(kind).startswith(key):
            return pk
    if not _warned_fallback_peaks:
        _warned_fallback_peaks = True
        import logging
        logging.getLogger(__name__).warning(
            'mxtpu perfwatch: card %r not in the peak table — perf.mfu '
            'uses the %s peaks; set MXTPU_PEAK_FLOPS to override', kind,
            DEFAULT_PEAK_KEY)
    return PEAKS[DEFAULT_PEAK_KEY]


def peaks(device=None):
    """Resolved (peak_flops, peak_bw), honoring the MXTPU_PEAK_FLOPS
    override for the flops term.  Cached once a card answered."""
    global _peaks
    override = float(config.get('MXTPU_PEAK_FLOPS'))
    if device is not None:
        pk = device_peaks(_live_device_kind(device))
    else:
        pk = _peaks
        if pk is None:
            kind = _live_device_kind()
            pk = device_peaks(kind)
            if kind != 'cpu':
                _peaks = pk
    if override > 0:
        return (override, pk[1])
    return pk


def peak_flops(device=None):
    return peaks(device)[0]


def mfu(step_flops, steps_per_sec, peak=None):
    """Model FLOPs utilization: a step's FLOPs × steps/sec over the
    card's peak.  0.0 when either term is unknown."""
    if not step_flops or not steps_per_sec:
        return 0.0
    peak = peak if peak else peak_flops()
    if not peak:
        return 0.0
    return float(step_flops) * float(steps_per_sec) / float(peak)


def roofline_mandatory(min_bytes, steps_per_sec, peak_bw=None):
    """Mandatory-traffic roofline fraction: the analytic minimum bytes a
    step must move × steps/sec over the peak bandwidth."""
    if not min_bytes or not steps_per_sec:
        return 0.0
    peak_bw = peak_bw if peak_bw else peaks()[1]
    if not peak_bw:
        return 0.0
    return float(min_bytes) * float(steps_per_sec) / float(peak_bw)


def note_step(kind, key, nsamples=0, device=None):
    """One training step dispatched: advance the rolling steps/sec window
    and publish ``perf.mfu`` / ``perf.steps_per_sec`` /
    ``perf.step_flops`` (and the card's memory gauges), and feed
    ``commwatch.on_step`` (the step interval, its collectives, the
    per-device FLOPs).  Two flag checks when both planes are off."""
    if not _on and not _comm_on:
        return
    comm = _comm if _comm_on else None
    now = time.monotonic()
    interval = (now - _step_window[-1]) if _step_window else None
    _step_window.append(now)
    if not _on:
        info = executable_info(kind, key) if key is not None else None
        ndev = info.get('num_devices', 1) if info else 1
        flops = info.get('global_flops', 0.0) if info else 0.0
        comm.on_step(kind, key, interval, flops / ndev)
        return
    instrument.inc('perf.steps')
    if nsamples:
        instrument.inc('perf.samples', int(nsamples))
    if len(_step_window) >= 2:
        dt = _step_window[-1] - _step_window[0]
        sps = (len(_step_window) - 1) / dt if dt > 0 else 0.0
    else:
        sps = 0.0
    info = None
    if key is not None:
        with _lock:
            info = _executables.get((str(kind), _keystr(key)))
    ndev = info.get('num_devices', 1) if info else 1
    flops = info.get('global_flops', 0.0) if info else 0.0
    instrument.set_gauge('perf.steps_per_sec', sps)
    instrument.set_gauge('perf.step_flops', flops)
    instrument.set_gauge('perf.num_devices', ndev)
    instrument.set_gauge('perf.mfu',
                         mfu(flops, sps, peak=peak_flops(device) * ndev))
    if comm is not None:
        comm.on_step(kind, key, interval, flops / ndev)
    if device is not None and torch.device(device).type == 'cuda':
        instrument.set_gauge('mem.device_allocated_bytes',
                             torch.cuda.memory_allocated(device))
        instrument.set_gauge('mem.device_peak_bytes',
                             torch.cuda.max_memory_allocated(device))
        instrument.set_gauge('mem.device_reserved_bytes',
                             torch.cuda.memory_reserved(device))


# ---------------------------------------------------------------------------
# Leg 2b: phases and the sampled step sync
# ---------------------------------------------------------------------------

_NULL_PHASE = instrument.NULL_CTX
_pending = deque()         # (name, start event, end event), oldest first
_HARVEST_AT = 256
events_recorded = 0        # CUDA events this plane recorded (tests)


class _DevicePhase(object):
    """A region timed on the card: an event before and after it on the
    current stream (outside any graph), read at the next harvest."""
    __slots__ = ('name', 'device', 'start')

    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        global events_recorded
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))
        events_recorded += 1
        return self

    def __exit__(self, *exc):
        global events_recorded
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        events_recorded += 1
        _pending.append((self.name, self.start, end))
        if len(_pending) >= _HARVEST_AT:
            harvest()
        return False


def phase(name, device=None):
    """Attribute the wrapped region to step phase ``name``
    (``perf.phase.<name>`` histogram, seconds): the card's time between
    two CUDA events when ``device`` is a CUDA device, else the host's
    (and a span under profiling).  The shared no-op when off."""
    if not _on:
        return _NULL_PHASE
    if device is not None and torch.device(device).type == 'cuda':
        return _DevicePhase('perf.phase.' + name, torch.device(device))
    return instrument.hist_span('perf.phase.' + name, cat='phase')


def harvest():
    """Read every recorded phase whose end event has completed (a
    non-blocking query, no host sync) into its histogram, oldest first;
    stops at the first one still running.  Called after each metric
    drain (whose transfer has completed everything recorded before it)
    and at the end of a fit."""
    n = 0
    while _pending:
        name, start, end = _pending[0]
        if not end.query():
            break
        _pending.popleft()
        instrument.observe_hist(name, start.elapsed_time(end) / 1e3)
        n += 1
    return n


def sample_tick():
    """Per-step sampling decision (MXTPU_STEP_SAMPLE=N: the 1st, N+1th,
    ... steps of a fit).  False (one flag check) when off."""
    global _sample_count
    if not _on or not _sample_n:
        return False
    _sample_count += 1
    return (_sample_count - 1) % _sample_n == 0


def sample_sync(ticket, t0, ts_us):
    """Full sync of a SAMPLED step: waits its ticket out, records the
    dispatch-to-completion latency as ``perf.step_latency``, counts
    ``perf.host_syncs`` and emits a ``perf.step`` span."""
    with phase('device_wait'):
        if isinstance(ticket, torch.cuda.Event):
            ticket.synchronize()
        else:
            from .engine import sync
            sync(ticket)
    dt = time.perf_counter() - t0
    instrument.observe_hist('perf.step_latency', dt)
    instrument.inc('perf.host_syncs')
    if instrument.profiling_enabled():
        dur_us = time.time_ns() // 1000 - int(ts_us)
        instrument.record_complete('perf.step', ts_us, max(dur_us, 0),
                                   cat='perf')


# ---------------------------------------------------------------------------
# Leg 3: memory ledger
# ---------------------------------------------------------------------------

_ledger_lock = threading.Lock()
_ledger_live = 0
_ledger_peak = 0
_sites = {}                # site -> [live_bytes, allocs]
_by_id = {}                # id(obj) -> entry (removed on free)

# entry: [site, nbytes, freed, obj_id]


def _nbytes(arr):
    h = getattr(arr, 'handle', arr)
    if isinstance(h, torch.Tensor):
        return h.numel() * h.element_size()
    try:
        return int(h.nbytes)
    except Exception:        # noqa: BLE001
        return 0


def _target(obj):
    """What a ledger entry follows: an NDArray's tensor, else ``obj``."""
    h = getattr(obj, 'handle', None)
    return h if isinstance(h, torch.Tensor) else obj


def _publish_ledger_locked():
    instrument.set_gauge('mem.live_bytes', _ledger_live)
    instrument.set_gauge('mem.peak_bytes', _ledger_peak)
    for site, (live, _n) in _sites.items():
        instrument.set_gauge('mem.site[%s].live_bytes' % site, live)


def _retire(entry, counter):
    """Shared free/donate path: idempotent per entry."""
    global _ledger_live
    with _ledger_lock:
        if entry[2]:
            return False
        entry[2] = True
        _ledger_live -= entry[1]
        site = _sites.get(entry[0])
        if site is not None:
            site[0] -= entry[1]
        _by_id.pop(entry[3], None)
        _publish_ledger_locked()
    instrument.inc(counter)
    return True


def _on_gc(entry):
    _retire(entry, 'mem.frees')


def ledger_alloc(site, obj, nbytes=None):
    """Account one allocation at ``site`` — a tensor (its bytes), or any
    object holding ``nbytes`` of device memory (a captured step and its
    graph pool) — and arm a finalizer for the free side.  Returns
    ``obj``.  One flag check when the plane is off."""
    global _ledger_live, _ledger_peak
    if not _on or obj is None:
        return obj
    n = int(nbytes) if nbytes is not None else _nbytes(obj)
    if not n:
        return obj
    ref = _target(obj)
    entry = [site, n, False, id(ref)]
    try:
        weakref.finalize(ref, _on_gc, entry)
    except TypeError:
        entry[2] = True
        instrument.inc('mem.allocs')
        return obj
    with _ledger_lock:
        _ledger_live += n
        if _ledger_live > _ledger_peak:
            _ledger_peak = _ledger_live
        s = _sites.get(site)
        if s is None:
            s = _sites[site] = [0, 0]
        s[0] += n
        s[1] += 1
        _by_id[entry[3]] = entry
        _publish_ledger_locked()
    instrument.inc('mem.allocs')
    return obj


def ledger_donate(obj):
    """Retire ``obj``'s entry NOW (its memory was handed on); its
    finalizer later finds the entry retired.  Unknown objects no-op."""
    if not _on or obj is None:
        return
    entry = _by_id.get(id(_target(obj)))
    if entry is not None:
        _retire(entry, 'mem.donations')


def ledger_top(k=8):
    """Top-``k`` sites by live bytes: ``[(site, live_bytes, allocs)]``."""
    with _ledger_lock:
        rows = [(site, live, n) for site, (live, n) in _sites.items()]
    rows.sort(key=lambda r: r[1], reverse=True)
    return rows[:k]


def ledger_stats():
    """The ledger's totals and sites, and the card's own totals from
    ``torch.cuda.memory_stats`` (``device``: empty when CUDA was never
    initialized)."""
    with _ledger_lock:
        out = {'live_bytes': _ledger_live, 'peak_bytes': _ledger_peak,
               'sites': {s: {'live_bytes': v[0], 'allocs': v[1]}
                         for s, v in _sites.items()}}
    stats = instrument.device_memory_stats()
    out['device'] = {k: stats[k] for k in (
        'allocated_bytes.all.current', 'allocated_bytes.all.peak',
        'reserved_bytes.all.current', 'reserved_bytes.all.peak')
        if k in stats}
    return out


def ledger_reset():
    """Forget all ledger state (tests)."""
    global _ledger_live, _ledger_peak
    with _ledger_lock:
        for entry in list(_by_id.values()):
            entry[2] = True
        _by_id.clear()
        _sites.clear()
        _ledger_live = 0
        _ledger_peak = 0


# ---------------------------------------------------------------------------
# Leg 4: OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ('resource_exhausted', 'resource exhausted',
                'out of memory', 'oom while')


def is_oom(exc):
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _OOM_MARKERS)


def forensics_snapshot(kind=None, key=None, error=None):
    """The OOM postmortem payload: the signature's row, the largest
    ledger entries, the card's memory totals and the current MFU/phase
    picture."""
    stats = ledger_stats()
    doc = {'error': str(error)[:2000] if error is not None else None,
           'ledger': {'top': [{'site': s, 'live_bytes': b, 'allocs': n}
                              for s, b, n in ledger_top(8)],
                      'live_bytes': stats['live_bytes'],
                      'peak_bytes': stats['peak_bytes']},
           'device_memory': stats['device'],
           'executables': executables()}
    info = executable_info(kind, key) if kind is not None and \
        key is not None else None
    doc['executable'] = info or ({'kind': str(kind), 'key': _keystr(key)}
                                 if kind is not None and key is not None
                                 else None)
    try:
        snap = instrument.metrics_snapshot()
        gauges = snap.get('gauges', {})
        doc['perf'] = {g: gauges[g] for g in
                       ('perf.mfu', 'perf.steps_per_sec',
                        'perf.step_flops', 'mem.live_bytes',
                        'mem.peak_bytes') if g in gauges}
        hists = snap.get('histograms') or {}
        doc['phases'] = {name: {'count': h.get('count'),
                                'sum': h.get('sum'),
                                'p50': h.get('p50'), 'p99': h.get('p99')}
                         for name, h in hists.items()
                         if name.startswith('perf.phase.')}
    except Exception:        # noqa: BLE001
        pass
    return doc


def on_error(exc, kind=None, key=None):
    """Dispatch-site exception hook: an out-of-memory error triggers the
    flight-recorder postmortem (when ``MXTPU_FLIGHT_RECORDER`` names a
    directory) naming the signature and the top ledger entries.  Any
    other exception passes through untouched.  Never raises."""
    try:
        if not is_oom(exc):
            return None
        instrument.inc('perf.ooms')
        from . import health
        if health.flight_recorder() is None:
            health.install_flight_recorder()
        return health.dump_flight(
            'oom', extra=forensics_snapshot(kind, key, exc))
    except Exception:        # noqa: BLE001
        return None


refresh()
