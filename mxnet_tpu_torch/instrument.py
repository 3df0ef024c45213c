"""Spans, counters, gauges, timers, latency histograms and decision
events — the port of ``mxnet_tpu/instrument.py``.

- **Spans** — nested, thread-aware timed regions (:func:`span`,
  :func:`instrumented`, :func:`record_complete`).  Each thread appends to
  its own bounded buffer (no lock on the hot path), events carry the
  real ``pid``/``tid``, and :func:`dump_trace` drains every buffer into
  one Chrome-trace JSON with ``process_name``/``thread_name`` metadata.
  :func:`recent_events` reads the tail without draining (the flight
  recorder's read path).
- **Metrics** — one registry of :class:`Counter` / :class:`Gauge` /
  :class:`Timer` / :class:`Histogram`.  Histograms share fixed log-scale
  buckets (quarter-decades from 1 us to 100 s) with one bucket-walk
  quantile estimate, remember the last exemplar (a serving request id)
  per bucket, and have windowed reads (:func:`hist_delta`,
  :class:`HistogramWindow`) and a label merge (:func:`hist_merge`).
  Per-entity series carry their labels in the name
  (``serving.flushes|model=m,replica=1``, :func:`split_labeled_name`),
  leave the registry with their entity (:func:`drop_labeled_metrics`)
  and render as real labels in :func:`render_prometheus`.
- **Decisions** — the control planes log what they do through
  :func:`decision`, a bounded ring with sinks.

Metrics are ON by default here (the reference's ``MXTPU_METRICS``
defaults to off): the launch counts and capture counters the card runs
read are always wanted.  ``MXTPU_METRICS=0`` or :func:`set_metrics`
turns counters, gauges, timers and histograms off; kernel launch counts
stay on.  ``MXTPU_PROFILE`` / :func:`set_profiling` turn spans on (and
imply metrics).  With either off, every call is a flag check.

The kernel wrappers count their launches here too (:func:`count_launch`).
Inside :func:`recording` the counts a thread makes are kept apart and
applied later, as often as wanted (:func:`apply_counts`): a CUDA graph
capture runs the step's host code once and launches nothing, and each
replay of the graph is a step.  A capture's recording also takes the
counts of any other thread whose current stream is capturing: the
autograd engine runs a captured backward (and a mirrored forward's
recompute in it) on its device thread.

The reference's jit-trace counters (``count_trace``, ``count_traces``,
``trace_redirect``) count JAX traces and have no counterpart: the port
counts its graph captures in ``compile_cache``.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import re
import sys
import threading
import time
import weakref

from . import config

__all__ = [
    'span', 'instrumented', 'dump_trace', 'trace_events', 'clear_trace',
    'record_complete', 'recent_events', 'dropped_totals',
    'counter', 'gauge', 'timer', 'histogram', 'counter_value',
    'drop_metric', 'drop_labeled_metrics',
    'hist_delta', 'hist_merge', 'HistogramWindow', 'HIST_EDGES',
    'inc', 'set_gauge', 'observe', 'observe_hist', 'timed', 'hist_span',
    'count_launch', 'recording', 'apply_counts',
    'decision', 'recent_decisions', 'on_decision', 'remove_decision_sink',
    'metrics_snapshot', 'dump_metrics', 'reset_metrics',
    'render_prometheus', 'split_labeled_name', 'device_memory_stats',
    'set_profiling', 'set_metrics', 'profiling_enabled', 'metrics_enabled',
]

# per-thread buffered events are capped so an always-on trace cannot grow
# without bound; overflow is counted
MAX_EVENTS_PER_THREAD = 1 << 20

_profile_on = False
_metrics_on = True
# metrics are on only because set_profiling(True) implied them, so
# set_profiling(False) can release them again
_metrics_implied = False


# ---------------------------------------------------------------------------
# Enable flags
# ---------------------------------------------------------------------------

def _refresh_from_env():
    """(Re)read MXTPU_PROFILE / MXTPU_METRICS; profiling implies
    metrics."""
    global _profile_on, _metrics_on, _metrics_implied
    _profile_on = bool(config.get('MXTPU_PROFILE'))
    explicit = bool(config.get('MXTPU_METRICS'))
    _metrics_on = _profile_on or explicit
    _metrics_implied = _profile_on and not explicit


def set_profiling(on):
    """Toggle span tracing.  On implies metrics; off releases metrics
    again unless they were on by themselves."""
    global _profile_on, _metrics_on, _metrics_implied
    _profile_on = bool(on)
    if _profile_on:
        if not _metrics_on:
            _metrics_implied = True
        _metrics_on = True
    elif _metrics_implied:
        _metrics_on = False
        _metrics_implied = False


def set_metrics(on):
    """Record (True) or drop (False) counters, gauges, timers and
    histograms; kernel launch counts are kept either way."""
    global _metrics_on, _metrics_implied
    _metrics_on = bool(on)
    _metrics_implied = False


def profiling_enabled():
    return _profile_on


def metrics_enabled():
    return _metrics_on


# ---------------------------------------------------------------------------
# Span buffers (one per thread, registered once)
# ---------------------------------------------------------------------------

class _ThreadBuffer(object):
    __slots__ = ('events', 'pid', 'tid', 'thread_name', 'dropped',
                 'dropped_reported', 'thread')

    def __init__(self):
        self.events = []
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        # monotonic, written only by the owning thread; drainers track
        # what they reported instead of resetting it
        self.dropped = 0
        self.dropped_reported = 0
        self.thread = weakref.ref(threading.current_thread())


_buffers = []
_buffers_lock = threading.Lock()
# serializes drainers; appends need no lock (list.append, slice copy and
# slice delete are each atomic under the GIL)
_drain_lock = threading.Lock()
_tls = threading.local()


def _buffer():
    buf = getattr(_tls, 'buf', None)
    if buf is None:
        buf = _ThreadBuffer()
        with _buffers_lock:
            _buffers.append(buf)
        _tls.buf = buf
    return buf


def _append_event(event):
    """Stamp the calling thread's pid/tid on ``event`` and buffer it."""
    buf = _buffer()
    event['pid'] = buf.pid
    event['tid'] = buf.tid
    if len(buf.events) >= MAX_EVENTS_PER_THREAD:
        buf.dropped += 1
        return
    buf.events.append(event)


class _NullSpan(object):
    """The disabled path: one shared instance, nothing allocated."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
# the shared disabled-path context of every plane (health, iowatch,
# perfwatch): one instance, nothing allocated when a plane is off
NULL_CTX = _NULL_SPAN


class _Span(object):
    __slots__ = ('name', 'cat', 'args', '_t0')

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dur = time.time_ns() - self._t0
        event = {'name': self.name, 'cat': self.cat, 'ph': 'X',
                 'ts': self._t0 // 1000, 'dur': max(dur, 0) // 1000}
        if self.args:
            event['args'] = self.args
        _append_event(event)
        return False


def span(name, cat='host', args=None):
    """Timed region as a Chrome-trace complete ('X') event; nesting is
    implicit.  Off: a shared no-op context manager (build ``args`` only
    behind :func:`profiling_enabled`)."""
    if not _profile_on:
        return _NULL_SPAN
    return _Span(name, cat, args)


def instrumented(name=None, cat='host'):
    """Decorator form of :func:`span` (the flag is checked per call)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _profile_on:
                return fn(*a, **kw)
            with _Span(label, cat, None):
                return fn(*a, **kw)
        return wrapper
    return deco


def record_complete(name, ts_us, dur_us, cat='op', args=None):
    """Append a complete event with explicit timestamps, whatever the
    flags say (an explicit call always records)."""
    event = {'name': name, 'cat': cat, 'ph': 'X', 'ts': ts_us,
             'dur': max(dur_us, 0)}
    if args:
        event['args'] = args
    _append_event(event)


def _drain_events():
    with _buffers_lock:
        bufs = list(_buffers)
    events = []
    dropped = 0
    with _drain_lock:
        for buf in bufs:
            # the owner may append meanwhile: take a length snapshot and
            # delete exactly that prefix, so nothing is lost
            n = len(buf.events)
            events.extend(buf.events[:n])
            del buf.events[:n]
            d = buf.dropped
            dropped += d - buf.dropped_reported
            buf.dropped_reported = d

    def _dead(b):
        t = b.thread()
        return (t is None or not t.is_alive()) and not b.events
    dead = [b for b in bufs if _dead(b)]
    if dead:
        with _buffers_lock:
            for b in dead:
                if b in _buffers:
                    _buffers.remove(b)
    events.sort(key=lambda e: e.get('ts', 0))
    return events, bufs, dropped


def trace_events():
    """Snapshot of the buffered events (not drained, no metadata)."""
    with _buffers_lock:
        bufs = list(_buffers)
    events = []
    for buf in bufs:
        events.extend(list(buf.events))
    events.sort(key=lambda e: e.get('ts', 0))
    return events


def recent_events(limit=256):
    """The newest ``limit`` buffered events across threads, by time,
    without draining (the flight recorder's read path)."""
    with _buffers_lock:
        bufs = list(_buffers)
    events = []
    for buf in bufs:
        evs = buf.events
        n = len(evs)
        events.extend(evs[n - limit if n > limit else 0:n])
    events.sort(key=lambda e: e.get('ts', 0))
    return events[-limit:] if len(events) > limit else events


def dropped_totals():
    """Events ever dropped by the bounded buffers (cumulative)."""
    with _buffers_lock:
        return sum(b.dropped for b in _buffers)


def clear_trace():
    _drain_events()


def dump_trace(path):
    """Drain every thread buffer into ``path`` as Chrome-trace JSON, the
    ``process_name``/``thread_name`` metadata after the data events.
    Returns the number of data events written."""
    events, bufs, dropped = _drain_events()
    meta = []
    seen_pids = set()
    seen_threads = set()
    for buf in bufs:
        if buf.pid not in seen_pids:
            seen_pids.add(buf.pid)
            meta.append({'name': 'process_name', 'ph': 'M', 'pid': buf.pid,
                         'args': {'name': 'mxnet_tpu_torch'}})
        # the OS reuses thread ids: dedup on the name too
        key = (buf.pid, buf.tid, buf.thread_name)
        if key not in seen_threads:
            seen_threads.add(key)
            meta.append({'name': 'thread_name', 'ph': 'M', 'pid': buf.pid,
                         'tid': buf.tid, 'args': {'name': buf.thread_name}})
    doc = {'traceEvents': events + meta, 'displayTimeUnit': 'ms'}
    if dropped:
        doc['mxtpuDroppedEvents'] = dropped
    with open(path, 'w') as f:
        json.dump(doc, f)
    return len(events)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

_metrics = {}
_metrics_lock = threading.Lock()


class Counter(object):
    """Monotonic accumulator; the read-modify-write takes the registry
    lock (threads increment it)."""
    __slots__ = ('name', 'value')

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        with _metrics_lock:
            self.value += n


class Gauge(object):
    """Last-write-wins value."""
    __slots__ = ('name', 'value')

    def __init__(self, name):
        self.name = name
        self.value = 0.0

    def set(self, value):
        self.value = value


class Timer(object):
    """Accumulated wall time and call count (time a region with
    :func:`timed`)."""
    __slots__ = ('name', 'total', 'count')

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0

    def observe(self, seconds):
        with _metrics_lock:
            self.total += seconds
            self.count += 1

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


def _quantile_from_counts(counts, total, q):
    """The one bucket-walk quantile estimate behind every histogram view
    (cumulative walk, linear inside the landing bucket); 0.0 when empty."""
    if not total:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= target:
            lo = HIST_EDGES[i - 1] if i > 0 else 0.0
            hi = HIST_EDGES[i] if i < len(HIST_EDGES) else HIST_EDGES[-1]
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return HIST_EDGES[-1]


# quarter-decades from 1 us to 100 s (observations are seconds)
HIST_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))


class Histogram(object):
    """Bounded-memory latency histogram on :data:`HIST_EDGES` with a
    running sum and count.  ``observe(value, exemplar=...)`` also keeps
    the LAST exemplar id (a serving request id) per bucket."""
    __slots__ = ('name', 'counts', 'sum', 'count', 'exemplars')

    def __init__(self, name):
        self.name = name
        self.counts = [0] * (len(HIST_EDGES) + 1)   # +1: overflow
        self.sum = 0.0
        self.count = 0
        self.exemplars = None         # bucket idx -> (id, value), lazy

    def observe(self, value, exemplar=None):
        value = float(value)
        with _metrics_lock:
            idx = bisect.bisect_left(HIST_EDGES, value)
            self.counts[idx] += 1
            self.sum += value
            self.count += 1
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[idx] = (str(exemplar), value)

    def quantile(self, q):
        """Estimate the ``q`` quantile; 0.0 when empty."""
        with _metrics_lock:
            counts = list(self.counts)
            total = self.count
        return _quantile_from_counts(counts, total, q)

    def snapshot(self):
        """count/sum/p50/p95/p99 and the CUMULATIVE nonzero buckets
        (``[le, cum_count]``); ``exemplars`` (``[le, id, value]``) when
        any observation carried one."""
        with _metrics_lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
            ex = dict(self.exemplars) if self.exemplars else None
        snap = _counts_to_snapshot(counts, total, s)
        if ex:
            snap['exemplars'] = [
                [HIST_EDGES[i] if i < len(HIST_EDGES) else '+Inf',
                 rid, val]
                for i, (rid, val) in sorted(ex.items())]
        return snap


# snapshot edges are the HIST_EDGES floats (JSON round-trips them
# exactly), so windowed math maps a snapshot back onto the layout
_EDGE_INDEX = {e: i for i, e in enumerate(HIST_EDGES)}


def _bucket_counts(snapshot):
    """Per-bucket (non-cumulative) counts of a snapshot, indexed like
    :data:`HIST_EDGES` (+1 overflow); an unknown edge folds into the
    bucket that covers it."""
    counts = [0] * (len(HIST_EDGES) + 1)
    prev = 0
    for le, cum in (snapshot or {}).get('buckets') or []:
        c = int(cum) - prev
        prev = int(cum)
        if c <= 0:
            continue
        if isinstance(le, str):              # '+Inf'
            idx = len(HIST_EDGES)
        else:
            idx = _EDGE_INDEX.get(float(le))
            if idx is None:
                idx = min(bisect.bisect_left(HIST_EDGES, float(le)),
                          len(HIST_EDGES))
        counts[idx] += c
    return counts


def _counts_to_snapshot(counts, total, s):
    buckets = []
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if c:
            buckets.append([HIST_EDGES[i] if i < len(HIST_EDGES)
                            else '+Inf', cum])
    return {'count': total, 'sum': s,
            'p50': _quantile_from_counts(counts, total, 0.50),
            'p95': _quantile_from_counts(counts, total, 0.95),
            'p99': _quantile_from_counts(counts, total, 0.99),
            'buckets': buckets}


def hist_delta(cur, prev=None):
    """The WINDOWED view between two cumulative snapshots (``prev``
    earlier): count/sum/quantiles of only the observations in between.
    ``prev`` None returns ``cur`` through the same path; a ``cur`` older
    than ``prev`` (a reset between them) clamps to empty."""
    cur = cur or {}
    cc = _bucket_counts(cur)
    total = int(cur.get('count', 0))
    s = float(cur.get('sum', 0.0))
    if prev:
        pc = _bucket_counts(prev)
        cc = [max(0, a - b) for a, b in zip(cc, pc)]
        total = max(0, total - int(prev.get('count', 0)))
        s = max(0.0, s - float(prev.get('sum', 0.0)))
    return _counts_to_snapshot(cc, total, s)


def hist_merge(snapshots):
    """Merge histogram snapshots into one: counts add bucket for bucket,
    quantiles re-estimated on the union (the model-level view of
    per-replica / per-lane series)."""
    counts = [0] * (len(HIST_EDGES) + 1)
    total, s = 0, 0.0
    for snap in snapshots:
        if not snap:
            continue
        for i, c in enumerate(_bucket_counts(snap)):
            counts[i] += c
        total += int(snap.get('count', 0))
        s += float(snap.get('sum', 0.0))
    return _counts_to_snapshot(counts, total, s)


class HistogramWindow(object):
    """Rolling window over registry histograms: each :meth:`delta` call
    returns the windowed view since the last call for that name.  One
    instance per consumer, so no consumer steals another's window."""

    def __init__(self):
        self._prev = {}

    def delta(self, name):
        """Windowed snapshot of ``name`` since the previous call (first
        call: since the series began).  A missing series reads empty and
        its window base is FORGOTTEN: a retired series recreated later
        (a reused replica slot) must not be clamped against the dead
        one's larger totals."""
        m = _metrics.get(name)
        if not isinstance(m, Histogram):
            self._prev.pop(name, None)
            return hist_delta({}, None)
        cur = m.snapshot()
        prev = self._prev.get(name)
        self._prev[name] = cur
        return hist_delta(cur, prev)

    def merged_delta(self, names):
        """:func:`hist_merge` of the windowed deltas of ``names``."""
        return hist_merge([self.delta(n) for n in names])

    def peek_names(self, prefix):
        """Registry histogram names starting with ``prefix``."""
        with _metrics_lock:
            return sorted(n for n, m in _metrics.items()
                          if isinstance(m, Histogram)
                          and n.startswith(prefix))

    def merged_delta_labeled(self, prefix, **labels):
        """:func:`hist_merge` of the windowed deltas of every labeled
        series under ``prefix`` whose labels match ``labels`` (the
        autoscaler's control input).  Window bases of retired series
        under the prefix are dropped."""
        live = set(self.peek_names(prefix))
        for n in [k for k in self._prev
                  if k.startswith(prefix) and k not in live]:
            del self._prev[n]
        names = []
        for n in sorted(live):
            _, nl = split_labeled_name(n)
            if nl and all(nl.get(k) == str(v) for k, v in labels.items()):
                names.append(n)
        return hist_merge([self.delta(n) for n in names])


class _HistSpan(object):
    """One region landing in a histogram and, under profiling, a span,
    off one ``time_ns`` read per edge."""
    __slots__ = ('name', 'cat', '_t0')

    def __init__(self, name, cat):
        self.name = name
        self.cat = cat

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dt = time.time_ns() - self._t0
        observe_hist(self.name, dt / 1e9)
        if _profile_on:
            record_complete(self.name, self._t0 // 1000,
                            max(dt, 0) // 1000, cat=self.cat)
        return False


def hist_span(name, cat='phase'):
    """Histogram + span region (not flag-gated itself: callers check
    their own plane's flag)."""
    return _HistSpan(name, cat)


class _TimedCtx(object):
    __slots__ = ('_timer', '_t0')

    def __init__(self, timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.observe(time.perf_counter() - self._t0)
        return False


def _get_metric(name, cls):
    m = _metrics.get(name)
    if m is None:
        with _metrics_lock:
            m = _metrics.get(name)
            if m is None:
                m = _metrics[name] = cls(name)
    if not isinstance(m, cls):
        raise TypeError('metric %r is a %s, not a %s'
                        % (name, type(m).__name__, cls.__name__))
    return m


def counter(name):
    return _get_metric(name, Counter)


def gauge(name):
    return _get_metric(name, Gauge)


def timer(name):
    return _get_metric(name, Timer)


def histogram(name) -> Histogram:
    return _get_metric(name, Histogram)


def counter_value(name, default=0):
    """Read a counter without creating it."""
    m = _metrics.get(name)
    return m.value if isinstance(m, Counter) else default


def drop_metric(name):
    """Remove one series, whatever its kind (True when it existed)."""
    with _metrics_lock:
        return _metrics.pop(name, None) is not None


def drop_labeled_metrics(**labels):
    """Remove every labeled series whose labels match all the given
    ``key=value`` pairs; returns how many went.  An unloaded model (or a
    removed replica) takes its whole series family with it."""
    if not labels:
        return 0
    want = {k: str(v) for k, v in labels.items()}
    with _metrics_lock:
        doomed = []
        for n in _metrics:
            _, nl = split_labeled_name(n)
            if nl and all(nl.get(k) == v for k, v in want.items()):
                doomed.append(n)
        for n in doomed:
            _metrics.pop(n, None)
    return len(doomed)


# -- kernel launch counts and capture recordings ------------------------------

_recorder = threading.local()
_capture = [None]       # the recording of the CUDA graph capture under way


def _recording_for(key, n):
    """Add to this thread's recording, or to the capture's when this
    thread's current stream is capturing; False when neither records."""
    rec = getattr(_recorder, 'counts', None)
    if rec is None:
        rec = _capture[0]
        if rec is None:
            return False
        import torch
        if not torch.cuda.is_current_stream_capturing():
            return False
    with _metrics_lock:
        rec[key] = rec.get(key, 0) + n
    return True


def count_launch(kernel, route=None):
    """One launch of ``kernel``, a wrapper with a ``launches`` count (and,
    with ``route``, a ``launches_by_route`` dict)."""
    if not _recording_for((kernel, route), 1):
        apply_counts({(kernel, route): 1})


@contextlib.contextmanager
def recording(capture=False):
    """Counter increments and kernel launches this thread counts inside
    the block go into the yielded dict instead of the registry; with
    ``capture`` (a CUDA graph capture on this thread), so do those of
    threads whose current stream is capturing."""
    prev = getattr(_recorder, 'counts', None)
    _recorder.counts = rec = {}
    if capture:
        _capture[0] = rec
    try:
        yield rec
    finally:
        _recorder.counts = prev
        if capture:
            _capture[0] = None


def apply_counts(rec):
    """Add what :func:`recording` kept: ``{counter name: n}`` and
    ``{(kernel, route): launches}``."""
    for key, n in rec.items():
        if isinstance(key, str):
            counter(key).inc(n)
            continue
        kernel, route = key
        with _metrics_lock:
            kernel.launches += n
            if route is not None:
                kernel.launches_by_route[route] += n


# -- hot-path helpers: one flag check, nothing allocated when off -------------

def inc(name, n=1):
    if not _metrics_on or _recording_for(name, n):
        return
    counter(name).inc(n)


def set_gauge(name, value):
    if _metrics_on:
        gauge(name).set(value)


def observe(name, seconds):
    if _metrics_on:
        timer(name).observe(seconds)


def observe_hist(name, value, exemplar=None):
    if _metrics_on:
        histogram(name).observe(value, exemplar)


def timed(name):
    """Context-manager timer (nests, shared across threads); no-op when
    metrics are off."""
    if not _metrics_on:
        return _NULL_SPAN
    return _TimedCtx(timer(name))


def reset_metrics():
    with _metrics_lock:
        _metrics.clear()


def device_memory_stats():
    """``torch.cuda.memory_stats`` of the current CUDA device; {} when
    CUDA was never initialized in this process (this never initializes
    it) or reports nothing."""
    torch = sys.modules.get('torch')
    if torch is None or not torch.cuda.is_initialized():
        return {}
    try:
        stats = torch.cuda.memory_stats(torch.cuda.current_device())
    except RuntimeError:
        return {}
    return dict(stats) if stats else {}


def metrics_snapshot():
    """The whole registry as one JSON-serializable dict: ``counters``,
    ``gauges``, ``timers``, ``histograms`` (when any) and
    ``device_memory`` (when the card reports it)."""
    snap = {'counters': {}, 'gauges': {}, 'timers': {}}
    hists = []
    with _metrics_lock:
        for m in list(_metrics.values()):
            if isinstance(m, Counter):
                snap['counters'][m.name] = m.value
            elif isinstance(m, Gauge):
                snap['gauges'][m.name] = m.value
            elif isinstance(m, Timer):
                snap['timers'][m.name] = {'total_sec': m.total,
                                          'count': m.count,
                                          'avg_sec': m.avg}
            elif isinstance(m, Histogram):
                hists.append(m)      # snapshot takes the lock itself
    if hists:
        snap['histograms'] = {m.name: m.snapshot() for m in hists}
    mem = device_memory_stats()
    if mem:
        snap['device_memory'] = mem
    return snap


def dump_metrics(path):
    snap = metrics_snapshot()
    with open(path, 'w') as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    return snap


# ---------------------------------------------------------------------------
# Decision events: the control planes' one log
# ---------------------------------------------------------------------------

DECISION_RING = 512

_decisions = []                  # bounded ring of decision events
_decision_lock = threading.Lock()
_decision_seq = {}               # subsystem -> last seq issued
_decision_last_t = {}            # subsystem -> last wall time stamped
_decision_sinks = []             # callables fed every event


def decision(subsystem, action, reason='', severity='info', **fields):
    """Record one control-plane decision and return it:
    ``{'t', 'subsystem', 'action', 'reason', 'severity', 'seq', **fields}``,
    ``seq`` monotonic per subsystem and ``t`` clamped non-decreasing per
    subsystem.  Always kept in the bounded ring; counted under metrics;
    a trace instant under profiling; each sink gets it, and a sink that
    raises cannot fail the caller."""
    subsystem = str(subsystem)
    with _decision_lock:
        seq = _decision_seq.get(subsystem, 0) + 1
        _decision_seq[subsystem] = seq
        t = time.time()
        last = _decision_last_t.get(subsystem)
        if last is not None and t < last:
            t = last
        _decision_last_t[subsystem] = t
        ev = {'t': t, 'subsystem': subsystem, 'action': str(action),
              'reason': str(reason), 'severity': str(severity),
              'seq': seq}
        for k, v in fields.items():
            if k not in ev:
                ev[k] = v
        _decisions.append(ev)
        del _decisions[:-DECISION_RING]
        sinks = list(_decision_sinks)
    if _metrics_on:
        inc('decision.events')
        inc('decision.%s' % subsystem)
    if _profile_on:
        args = {'subsystem': subsystem, 'action': ev['action'],
                'reason': ev['reason'], 'seq': seq}
        for k in ('model', 'replica', 'rank', 'series'):
            if k in ev:
                args[k] = ev[k]
        record_complete('decision.%s.%s' % (subsystem, ev['action']),
                        int(t * 1e6), 0, cat='decision', args=args)
    for sink in sinks:
        try:
            sink(ev)
        except Exception:        # noqa: BLE001 - a sink never fails a site
            pass
    return ev


def recent_decisions(limit=None, subsystem=None):
    """The newest decision events, oldest first."""
    with _decision_lock:
        evs = list(_decisions)
    if subsystem is not None:
        evs = [e for e in evs if e.get('subsystem') == subsystem]
    if limit is not None:
        evs = evs[-int(limit):]
    return evs


def on_decision(fn):
    """Feed ``fn(event)`` every later decision (idempotent)."""
    with _decision_lock:
        if fn not in _decision_sinks:
            _decision_sinks.append(fn)


def remove_decision_sink(fn):
    with _decision_lock:
        if fn in _decision_sinks:
            _decision_sinks.remove(fn)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_PROM_BAD = re.compile(r'[^a-zA-Z0-9_:]')


def _prom_name(name, suffix=''):
    """``metric.host_syncs`` -> ``mxtpu_metric_host_syncs``."""
    s = _PROM_BAD.sub('_', str(name))
    if s and s[0].isdigit():
        s = '_' + s
    return 'mxtpu_' + s + suffix


def _prom_value(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return '0'
    if f != f:
        return 'NaN'
    if f == float('inf'):
        return '+Inf'
    if f == float('-inf'):
        return '-Inf'
    return str(int(f)) if f.is_integer() else repr(f)


def split_labeled_name(name):
    """``'base|k=v,k2=v2'`` -> ``('base', {'k': 'v', 'k2': 'v2'})``; a
    name without ``|`` -> ``(name, None)``."""
    if '|' not in str(name):
        return name, None
    base, _, rest = str(name).partition('|')
    labels = {}
    for part in rest.split(','):
        k, eq, v = part.partition('=')
        if eq and k:
            labels[k] = v
    return base, (labels or None)


def render_prometheus(snapshot=None, labels=None, seen_types=None,
                      timestamp_ms=None):
    """Render a metrics snapshot (default: the live registry) as
    Prometheus text.  Counters become ``<name>_total``, timers
    ``<name>_seconds_total`` + ``<name>_calls_total``, histograms
    cumulative ``_bucket{le=}`` lines (closed by ``+Inf``) with
    OpenMetrics exemplars where a bucket has one, ``_sum`` and
    ``_count``.  A ``|key=value`` section of a name becomes real labels
    under ONE ``# TYPE`` family; ``labels`` adds labels to every sample
    (they win on a collision); one shared ``seen_types`` across calls
    emits each ``# TYPE`` once; ``timestamp_ms`` (True: now) stamps
    every sample line."""
    snap = metrics_snapshot() if snapshot is None else snapshot
    seen = seen_types if seen_types is not None else set()
    if timestamp_ms is True:
        timestamp_ms = int(time.time() * 1000)
    stamp = '' if not timestamp_ms else ' %d' % int(timestamp_ms)

    def labstr(d):
        if not d:
            return ''
        # label-value escapes: backslash, double quote, newline
        return '{%s}' % ','.join(
            '%s="%s"' % (k, str(v).replace('\\', '\\\\')
                         .replace('"', '\\"').replace('\n', '\\n'))
            for k, v in sorted(d.items()))

    def merged(name_labels):
        if not name_labels:
            return labels
        out = dict(name_labels)
        if labels:
            out.update(labels)
        return out

    lines = []

    def emit(k, typ, value, suffix=''):
        base, name_labels = split_labeled_name(k)
        name = _prom_name(base, suffix)
        if name not in seen:
            seen.add(name)
            lines.append('# TYPE %s %s' % (name, typ))
        lines.append('%s%s %s%s' % (name, labstr(merged(name_labels)),
                                    _prom_value(value), stamp))

    for k, v in sorted((snap.get('counters') or {}).items()):
        emit(k, 'counter', v, '_total')
    for k, v in sorted((snap.get('gauges') or {}).items()):
        emit(k, 'gauge', v)
    for k, t in sorted((snap.get('timers') or {}).items()):
        t = t or {}
        emit(k, 'counter', t.get('total_sec', 0.0), '_seconds_total')
        emit(k, 'counter', t.get('count', 0), '_calls_total')
    for k, h in sorted((snap.get('histograms') or {}).items()):
        h = h or {}
        base_name, name_labels = split_labeled_name(k)
        name = _prom_name(base_name)
        if name not in seen:
            seen.add(name)
            lines.append('# TYPE %s histogram' % name)
        series = merged(name_labels)
        lab = labstr(series)
        base = dict(series) if series else {}
        buckets = list(h.get('buckets') or [])
        if not buckets or buckets[-1][0] != '+Inf':
            buckets.append(['+Inf', int(h.get('count', 0))])
        exemplars = {}
        for ex in h.get('exemplars') or []:
            try:
                le, rid, val = ex
            except (TypeError, ValueError):
                continue
            key = le if isinstance(le, str) else _prom_value(le)
            exemplars[key] = (rid, val)
        for le, cum in buckets:
            bl = dict(base)
            bl['le'] = le if isinstance(le, str) else _prom_value(le)
            ex = exemplars.get(bl['le'])
            tail = '' if ex is None else \
                ' # {request_id="%s"} %s' % (ex[0], _prom_value(ex[1]))
            lines.append('%s_bucket%s %d%s%s'
                         % (name, labstr(bl), cum, stamp, tail))
        lines.append('%s_sum%s %s%s' % (name, lab,
                                        _prom_value(h.get('sum', 0.0)),
                                        stamp))
        lines.append('%s_count%s %s%s' % (name, lab,
                                          _prom_value(h.get('count', 0)),
                                          stamp))
    return '\n'.join(lines) + '\n' if lines else ''


_refresh_from_env()
