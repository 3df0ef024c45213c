"""Counters, gauges and latency histograms of the serving slice.

The port copies only the metric kinds of ``mxnet_tpu/instrument.py``
that the batcher and executor record: monotonic counters, last-write
gauges and bounded-memory histograms on the same fixed log-scale
buckets (quarter-decades from 1 us to 100 s), with the same bucket-walk
quantile estimate.  Metrics are always on here: each record is one lock
and an add.

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

__all__ = ['inc', 'count_launch', 'recording', 'apply_counts',
           'set_gauge', 'observe_hist', 'counter_value',
           'histogram', 'metrics_snapshot', 'reset_metrics', 'HIST_EDGES']

HIST_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))

_lock = threading.Lock()
_counters = {}
_gauges = {}
_hists = {}


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
        """Estimate the ``q`` quantile by walking the cumulative bucket
        counts and interpolating linearly inside the landing bucket;
        0.0 when empty."""
        with _lock:
            counts = list(self.counts)
            total = self.count
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

    def snapshot(self):
        with _lock:
            total, s = self.count, self.sum
        return {'count': total, 'sum': s, 'p50': self.quantile(0.50),
                'p95': self.quantile(0.95), 'p99': self.quantile(0.99)}


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
    if _recording_for(name, n):
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
    with _lock:
        _gauges[name] = value


def histogram(name) -> Histogram:
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram(name)
    return h


def observe_hist(name, value):
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
