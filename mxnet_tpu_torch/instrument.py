"""Counters, gauges, latency histograms and decision events.

The port copies the metric kinds of ``mxnet_tpu/instrument.py`` that the
serving fleet, the batcher and the executor record: monotonic counters,
last-write gauges and bounded-memory histograms on the same fixed
log-scale buckets (quarter-decades from 1 us to 100 s), with the same
bucket-walk quantile estimate, snapshot layout and label-merge
(:func:`hist_merge`).  Per-entity series carry their labels in the name
(``serving.flushes|model=m,replica=1``, :func:`split_labeled_name`) and
leave the registry with their entity (:func:`drop_labeled_metrics`).
The control planes log what they do through :func:`decision`, a bounded
ring with sinks, as in the reference.

Metrics are ON by default here (the reference's default is
``MXTPU_METRICS``, off): the launch counts and capture counters the card
runs read are always wanted.  :func:`set_metrics` turns counters, gauges
and histograms off or on; kernel launch counts stay on.

The kernel wrappers count their launches here too (:func:`count_launch`).
Inside :func:`recording` the counts a thread makes are kept apart and
applied later, as often as wanted (:func:`apply_counts`): a CUDA graph
capture runs the step's host code once and launches nothing, and each
replay of the graph is a step.  A capture's recording also takes the
counts of any other thread whose current stream is capturing: the
autograd engine runs a captured backward (and a mirrored forward's
recompute in it) on its device thread.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time

__all__ = ['inc', 'count_launch', 'recording', 'apply_counts',
           'set_gauge', 'observe_hist', 'counter_value',
           'histogram', 'metrics_snapshot', 'reset_metrics', 'HIST_EDGES',
           'set_metrics', 'metrics_enabled', 'hist_merge',
           'split_labeled_name', 'drop_metric', 'drop_labeled_metrics',
           'decision', 'recent_decisions', 'on_decision',
           'remove_decision_sink']

HIST_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))

_lock = threading.Lock()
_counters = {}
_gauges = {}
_hists = {}
_metrics_on = True


def set_metrics(on):
    """Record (True) or drop (False) counters, gauges and histograms
    (``mxnet_tpu/instrument.py:105``); kernel launch counts are kept
    either way."""
    global _metrics_on
    _metrics_on = bool(on)


def metrics_enabled():
    return _metrics_on


def _quantile_from_counts(counts, total, q):
    """The ``q`` quantile of a bucket-count list: walk the cumulative
    counts and interpolate linearly inside the landing bucket; 0.0 when
    empty."""
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


def _counts_to_snapshot(counts, total, s):
    """count/sum/p50/p95/p99 plus the CUMULATIVE nonzero buckets
    (``[le, cum_count]``, ``'+Inf'`` for the overflow)."""
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


def hist_merge(snapshots):
    """Merge histogram snapshots (one bucket layout) into one: counts
    add bucket for bucket, quantiles re-estimated on the union — the
    model-level view of per-replica / per-lane series
    (``mxnet_tpu/instrument.py:599``)."""
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


class Histogram(object):
    """Fixed-bucket histogram with a running sum and count."""
    __slots__ = ('name', 'counts', 'sum', 'count')

    def __init__(self, name):
        self.name = name
        self.counts = [0] * (len(HIST_EDGES) + 1)   # +1: overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        with _lock:
            self.counts[bisect.bisect_left(HIST_EDGES, value)] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q):
        """Estimate the ``q`` quantile; 0.0 when empty."""
        with _lock:
            counts = list(self.counts)
            total = self.count
        return _quantile_from_counts(counts, total, q)

    def snapshot(self):
        """count/sum/quantiles and the cumulative nonzero buckets."""
        with _lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        return _counts_to_snapshot(counts, total, s)


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
    with _lock:
        rec[key] = rec.get(key, 0) + n
    return True


def inc(name, n=1):
    if not _metrics_on or _recording_for(name, n):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


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
    with _lock:
        for key, n in rec.items():
            if isinstance(key, str):
                _counters[key] = _counters.get(key, 0) + n
                continue
            kernel, route = key
            kernel.launches += n
            if route is not None:
                kernel.launches_by_route[route] += n


def counter_value(name, default=0):
    with _lock:
        return _counters.get(name, default)


def set_gauge(name, value):
    if not _metrics_on:
        return
    with _lock:
        _gauges[name] = value


def histogram(name) -> Histogram:
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram(name)
    return h


def observe_hist(name, value):
    if _metrics_on:
        histogram(name).observe(value)


def metrics_snapshot():
    """``{'counters', 'gauges', 'histograms'}`` as plain dicts."""
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = list(_hists.values())
    return {'counters': counters, 'gauges': gauges,
            'histograms': {h.name: h.snapshot() for h in hists}}


def reset_metrics():
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


def split_labeled_name(name):
    """``'base|k=v,k2=v2'`` -> ``('base', {'k': 'v', 'k2': 'v2'})``; a
    name without ``|`` -> ``(name, None)`` (``mxnet_tpu/instrument.py
    :1075``)."""
    if '|' not in str(name):
        return name, None
    base, _, rest = str(name).partition('|')
    labels = {}
    for part in rest.split(','):
        k, eq, v = part.partition('=')
        if eq and k:
            labels[k] = v
    return base, (labels or None)


def drop_metric(name):
    """Remove one series, whatever its kind (True when it existed)."""
    with _lock:
        found = False
        for reg in (_counters, _gauges, _hists):
            found = reg.pop(name, None) is not None or found
        return found


def drop_labeled_metrics(**labels):
    """Remove every labeled series whose labels match all the given
    ``key=value`` pairs; returns how many went.  An unloaded model (or a
    removed replica) takes its whole series family with it."""
    if not labels:
        return 0
    want = {k: str(v) for k, v in labels.items()}
    n = 0
    with _lock:
        for reg in (_counters, _gauges, _hists):
            for name in list(reg):
                _, got = split_labeled_name(name)
                if got and all(got.get(k) == v for k, v in want.items()):
                    del reg[name]
                    n += 1
    return n


# -- decision events: the control planes' one log ---------------------------
DECISION_RING = 512

_decisions = []                  # bounded ring of decision events
_decision_lock = threading.Lock()
_decision_seq = {}               # subsystem -> last seq issued
_decision_last_t = {}            # subsystem -> last wall time stamped
_decision_sinks = []             # callables fed every event


def decision(subsystem, action, reason='', severity='info', **fields):
    """Record one control-plane decision and return it
    (``mxnet_tpu/instrument.py:848``): ``{'t', 'subsystem', 'action',
    'reason', 'severity', 'seq', **fields}``, ``seq`` monotonic per
    subsystem and ``t`` clamped non-decreasing per subsystem.  Always
    kept in the bounded ring; counted under metrics; each sink gets it,
    and a sink that raises cannot fail the caller."""
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
    inc('decision.events')
    inc('decision.%s' % subsystem)
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
