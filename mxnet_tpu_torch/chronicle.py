"""Chronicle plane — continuous telemetry journal, online anomaly
detection and the decision timeline's recorder; the port of
``mxnet_tpu/chronicle.py``.

1. **Continuous telemetry journal** — a background sampler thread
   (named ``mxtpu-chronicle``) scrapes :func:`instrument.metrics_snapshot`
   every ``MXTPU_CHRONICLE_EVERY_MS`` into an append-only JSONL journal
   under ``MXTPU_CHRONICLE=<dir>``: counters as ``[total, delta, rate]``
   triples, gauges as values, histograms as cumulative-bucket vectors (so
   any two samples diff into a windowed distribution through
   :func:`instrument.hist_delta`).  The active segment is plain appends
   (a torn tail after ``kill -9`` is tolerated by every reader); rotation
   commits the closed segment through :func:`resilience.atomic_replace`,
   and closed segments ride a ``MXTPU_CHRONICLE_MAX_MB`` ring bound.
   :func:`query` reads a series over a trailing window: mean/min/max/
   last, the least-squares slope, and windowed histogram p-estimates.

2. **Online anomaly detection** — :class:`detector.SeriesDetector`
   baselines (median/MAD with hysteresis and settle windows) ride every
   sample over ``perf.steps_per_sec`` (low), ``goodput.fraction`` (low),
   the windowed ``serving.e2e_secs`` p99 (high, label-merged),
   ``serving.queue_depth`` (high) and the ``mem.live_bytes`` slope (the
   leak detector).  A breach emits a ``chronicle/anomaly`` decision
   event, a throttled warning, and a durable
   ``flightrec-*-anomaly.json`` postmortem with the offending window
   (through the installed flight recorder, else written into the journal
   directory).

3. **Decision recorder** — an :func:`instrument.on_decision` sink writes
   every typed :func:`instrument.decision` event (autoscaler, supervisor,
   health skip/abort, the fault plane, chronicle's own anomalies) into
   the journal the moment it happens.

Off by default: with ``MXTPU_CHRONICLE`` unset no thread starts,
:func:`query` returns ``{}``, and every hook is a single module-global
check.  On, the plane implies the metrics registry.  :func:`refresh`
starts it from the knob, at import (as the reference does) and at each
``fit``.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import re
import threading
import time
from collections import deque

from . import config, detector, instrument, resilience

__all__ = [
    'enabled', 'refresh', 'start', 'stop', 'query', 'active',
    'Chronicle', 'default_detectors',
]

_log = logging.getLogger('mxnet_tpu_torch.chronicle')

# name of the sampler thread — the off-by-default test greps live
# thread names for it
THREAD_NAME = 'mxtpu-chronicle'

ACTIVE_NAME = 'journal-active.jsonl'
_SEG_RE = re.compile(r'^journal-(\d{6})\.jsonl$')

# closed-segment size target: an eighth of the ring so the ring bound
# is enforced at useful granularity, floored so tiny test bounds still
# rotate instead of producing one-line segments
_SEG_DIVISOR = 8
_MIN_SEG_BYTES = 1024

# seconds between repeated anomaly warns for the SAME series — the
# throttle keeps a sustained anomaly from flooding the log while the
# journal records every decision anyway
WARN_INTERVAL_S = 30.0

# in-memory sample retention for query() (disk is the fallback for
# longer windows)
_MEM_SAMPLES = 4096

_UNSAFE = re.compile(r'[^A-Za-z0-9._-]+')


def default_detectors():
    """The stock detector set over the key series (fresh instances).

    Level detectors arm after ``min_samples`` baseline samples and
    fire after 2 consecutive >=4-MAD excursions on the watched side;
    the leak detector judges the trailing window's least-squares slope
    instead (sustained growth >10% of the level per window).  The leak
    detector alone judges nothing until a FULL trailing window exists
    and then requires a further full window of consecutive breaching
    evaluations: training startup allocates its working set in one
    legitimate ramp, which reads as extreme growth until it slides out
    of the trailing window ~one window after it ends — well before the
    streak threshold — while a real leak keeps breaching indefinitely
    and still fires within two windows."""
    mk = detector.SeriesDetector
    dets = [
        mk('perf.steps_per_sec', direction='low'),
        mk('goodput.fraction', direction='low'),
        mk('serving.queue_depth', direction='high'),
        mk('serving.e2e_secs:p99', direction='high'),
        mk('mem.live_bytes', direction='slope', min_samples=32,
           fire_after=32),
    ]
    return {d.series: d for d in dets}


class Chronicle(object):
    """One journal directory: sampler state, segment rotation, anomaly
    detectors, and the decision sink.  Pure state machine — the module
    singleton wires the thread and the env knobs around it, so tests
    drive :meth:`sample` with explicit timestamps and no clock."""

    def __init__(self, dirpath, every_ms=None, max_mb=None,
                 detect=None, detectors=None, rank=None):
        self.dir = str(dirpath)
        self.every_s = max(0.01, float(
            config.get('MXTPU_CHRONICLE_EVERY_MS')
            if every_ms is None else every_ms) / 1000.0)
        max_mb = config.get('MXTPU_CHRONICLE_MAX_MB') \
            if max_mb is None else max_mb
        self.max_bytes = max(_MIN_SEG_BYTES * 2,
                             int(float(max_mb) * 1024 * 1024))
        self.seg_bytes = max(_MIN_SEG_BYTES,
                             self.max_bytes // _SEG_DIVISOR)
        if detect is None:
            detect = config.get('MXTPU_CHRONICLE_DETECT')
        self.detectors = dict(detectors) if detectors is not None \
            else (default_detectors() if detect else {})
        self.rank = os.environ.get('MXTPU_PROCESS_ID', '0') \
            if rank is None else str(rank)
        self._wlock = threading.RLock()      # journal writes + rotation
        self._fh = None
        self._active_bytes = 0
        self._samples = deque(maxlen=_MEM_SAMPLES)   # parsed records
        self._prev_counters = {}
        self._prev_t = None
        self._prev_e2e = None     # merged serving.e2e_secs cum snapshot
        self._warned = {}         # series -> wall time of last warn
        self._thread = None
        self._stopper = threading.Event()
        os.makedirs(self.dir, exist_ok=True)
        self._seg_seq = self._scan_next_seq()
        self._open_active()

    # -- journal file plumbing ---------------------------------------------

    def _scan_next_seq(self):
        hi = 0
        try:
            for name in os.listdir(self.dir):
                m = _SEG_RE.match(name)
                if m:
                    hi = max(hi, int(m.group(1)))
        except OSError:
            pass
        return hi + 1

    def _open_active(self):
        path = os.path.join(self.dir, ACTIVE_NAME)
        self._fh = open(path, 'a')
        self._active_bytes = self._fh.tell()

    def _write(self, rec):
        line = json.dumps(rec, sort_keys=True,
                          separators=(',', ':')) + '\n'
        with self._wlock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()
            self._active_bytes += len(line)
            if self._active_bytes >= self.seg_bytes:
                self._rotate_locked()

    def _rotate_locked(self):
        """Commit the active segment as the next closed segment (the
        atomic_replace commit: a crash mid-rotation leaves either the
        previous state or the fully-fsynced segment, never a torn one)
        and enforce the ring bound."""
        active = os.path.join(self.dir, ACTIVE_NAME)
        self._fh.close()
        self._fh = None
        seg = os.path.join(self.dir,
                           'journal-%06d.jsonl' % self._seg_seq)
        try:
            with resilience.atomic_replace(seg) as tmp:
                with open(active, 'rb') as src, open(tmp, 'wb') as dst:
                    dst.write(src.read())
            os.remove(active)
            self._seg_seq += 1
        except OSError:
            _log.warning('mxtpu chronicle: segment rotation failed',
                         exc_info=True)
        self._open_active()
        self._enforce_ring_locked()
        instrument.inc('chronicle.rotations')

    def _segments(self):
        """Closed segments as sorted [(seq, path, bytes)]."""
        out = []
        try:
            for name in os.listdir(self.dir):
                m = _SEG_RE.match(name)
                if not m:
                    continue
                path = os.path.join(self.dir, name)
                try:
                    out.append((int(m.group(1)), path,
                                os.path.getsize(path)))
                except OSError:
                    continue
        except OSError:
            pass
        out.sort()
        return out

    def _enforce_ring_locked(self):
        segs = self._segments()
        total = sum(sz for _, _, sz in segs) + self._active_bytes
        while segs and total > self.max_bytes:
            _, path, sz = segs.pop(0)
            try:
                os.remove(path)
            except OSError:
                break
            total -= sz
            instrument.inc('chronicle.segments_dropped')

    # -- sampling ----------------------------------------------------------

    def sample(self, now=None):
        """Take one registry sample: journal it, remember it for
        :meth:`query`, and feed the detectors.  ``now`` is a wall-time
        override for deterministic tests."""
        t = time.time() if now is None else float(now)
        snap = instrument.metrics_snapshot()
        dt = (t - self._prev_t) if self._prev_t is not None else 0.0
        counters = {}
        for name, total in (snap.get('counters') or {}).items():
            prev = self._prev_counters.get(name)
            delta = total if prev is None else max(0, total - prev)
            rate = (delta / dt) if dt > 0 else 0.0
            counters[name] = [total, delta, round(rate, 6)]
            self._prev_counters[name] = total
        hists = {}
        for name, h in (snap.get('histograms') or {}).items():
            hists[name] = {'count': h.get('count', 0),
                           'sum': h.get('sum', 0.0),
                           'buckets': h.get('buckets', [])}
        rec = {'kind': 'sample', 't': t,
               'counters': counters,
               'gauges': dict(snap.get('gauges') or {}),
               'hists': hists}
        self._prev_t = t
        self._samples.append(rec)
        self._write(rec)
        instrument.inc('chronicle.samples')
        if self.detectors:
            self._detect(t, rec)
        return rec

    # -- anomaly detection -------------------------------------------------

    def _series_value(self, series, rec):
        """Resolve one detector series against a sample record.  Gauge
        series read the gauge; the ``serving.e2e_secs:p99`` series is
        derived per sample: label-merge every e2e histogram, diff
        against the previous merged snapshot, read the windowed p99
        (no traffic in the window = no sample: silence is never
        judged)."""
        if series == 'serving.e2e_secs:p99':
            merged = instrument.hist_merge([
                h for name, h in rec['hists'].items()
                if instrument.split_labeled_name(name)[0] ==
                'serving.e2e_secs'])
            prev, self._prev_e2e = self._prev_e2e, merged
            if not merged.get('count'):
                return None
            win = instrument.hist_delta(merged, prev)
            if not win.get('count'):
                return None
            return win.get('p99')
        return rec['gauges'].get(series)

    def _detect(self, t, rec):
        for series, det in self.detectors.items():
            v = self._series_value(series, rec)
            if v is None:
                continue
            out = det.observe(t, v)
            if out is None:
                continue
            verdict, info = out
            if verdict == 'anomaly':
                self._anomaly(info)
            else:
                instrument.decision(
                    'chronicle', 'anomaly_cleared',
                    reason='%s back in band' % info['series'],
                    series=info['series'], value=info['value'],
                    baseline=info['baseline'])

    def _anomaly(self, info):
        series = info['series']
        span = (info['window'][-1][0] - info['window'][0][0]) \
            if len(info['window']) >= 2 else 0.0
        reason = ('%s %s: value %.6g vs baseline %.6g '
                  '(magnitude %.2f, window %d samples / %.1fs)'
                  % (series,
                     'leaking' if info['direction'] == 'slope'
                     else 'out of band',
                     info['value'], info['baseline'],
                     info['magnitude'], len(info['window']), span))
        instrument.inc('chronicle.anomalies')
        instrument.decision('chronicle', 'anomaly', reason=reason,
                            severity='warn', series=series,
                            value=info['value'],
                            baseline=info['baseline'],
                            magnitude=info['magnitude'],
                            rank=self.rank)
        now = time.time()
        last = self._warned.get(series)
        if last is None or now - last >= WARN_INTERVAL_S:
            self._warned[series] = now
            _log.warning('mxtpu chronicle: ANOMALY %s', reason)
        self._postmortem(series, reason, info)

    def _postmortem(self, series, reason, info):
        """Durable ``flightrec-*-anomaly.json`` embedding the offending
        window: through the installed flight recorder when one exists
        (full spans + metrics context), else committed directly into
        the journal dir — an anomaly postmortem must not require the
        profiling plane."""
        safe = _UNSAFE.sub('_', series)
        payload = {'reason': reason, 'series': series,
                   'direction': info['direction'], 't': info['t'],
                   'value': info['value'],
                   'baseline': info['baseline'], 'mad': info['mad'],
                   'magnitude': info['magnitude'],
                   'window': [[t, v] for t, v in info['window']]}
        try:
            from . import health
            if health.dump_flight('%s-anomaly' % safe,
                                  extra=payload) is not None:
                return
        except Exception:
            _log.warning('mxtpu chronicle: flight-recorder postmortem '
                         'failed', exc_info=True)
        path = os.path.join(self.dir, 'flightrec-rank%s-%s-anomaly.json'
                            % (self.rank, safe))
        try:
            with resilience.atomic_replace(path) as tmp:
                with open(tmp, 'w') as f:
                    json.dump({'reason': '%s-anomaly' % safe,
                               'rank': self.rank, 'wall_time': info['t'],
                               'anomaly': payload}, f, indent=1,
                              sort_keys=True)
        except OSError:
            _log.warning('mxtpu chronicle: anomaly postmortem write '
                         'failed', exc_info=True)

    # -- decision sink -----------------------------------------------------

    def record_decision(self, ev):
        """The :func:`instrument.on_decision` sink: journal every typed
        decision event the moment it is emitted."""
        self._write({'kind': 'decision', 't': ev.get('t'), 'ev': ev})

    # -- query -------------------------------------------------------------

    def _window_samples(self, window_s, now=None):
        now = time.time() if now is None else float(now)
        cutoff = now - float(window_s)
        mem = [r for r in self._samples if r['t'] >= cutoff]
        mem_earliest = self._samples[0]['t'] if self._samples \
            else float('inf')
        if mem_earliest <= cutoff:
            return mem
        # the window predates memory: walk the journal newest-first —
        # the active segment first (a fresh Chronicle over an existing
        # dir holds NOTHING in memory, so the previous process's
        # uncommitted tail lives only there; the t < mem_earliest
        # filter keeps this process's own appends from double-counting)
        # then the closed segments
        older = []
        paths = [p for _, p, _ in self._segments()]
        paths.append(os.path.join(self.dir, ACTIVE_NAME))
        for path in reversed(paths):
            seg, seg_oldest = [], None
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            r = json.loads(line)
                        except ValueError:
                            continue      # torn line — skip, keep going
                        if r.get('kind') != 'sample':
                            continue
                        t = r.get('t')
                        if not isinstance(t, (int, float)):
                            continue
                        if seg_oldest is None or t < seg_oldest:
                            seg_oldest = t
                        if cutoff <= t < mem_earliest:
                            seg.append(r)
            except OSError:
                continue
            older = seg + older
            if seg_oldest is not None and seg_oldest < cutoff:
                break     # everything older is out of window
        return older + mem

    def query(self, series, window_s, now=None):
        """Windowed read of one series over the trailing ``window_s``
        seconds.  Gauges -> the values; counters -> the per-sample
        rates (plus the summed delta); histograms (exact or labeled
        base name) -> the windowed distribution between the window's
        first and last snapshots.  Scalar results carry
        mean/min/max/last and the least-squares ``slope`` (units/sec);
        an unknown or silent series returns ``{}``."""
        samples = self._window_samples(window_s, now=now)
        if not samples:
            return {}
        pts = [(r['t'], r['gauges'][series]) for r in samples
               if series in r['gauges']]
        if pts:
            return self._scalar('gauge', pts)
        cpts = [(r['t'], r['counters'][series]) for r in samples
                if series in r['counters']]
        if cpts:
            out = self._scalar('counter',
                               [(t, v[2]) for t, v in cpts])
            out['delta'] = sum(v[1] for _, v in cpts)
            out['total'] = cpts[-1][1][0]
            return out
        hsnaps = []
        for r in samples:
            hs = [h for name, h in r['hists'].items()
                  if name == series or
                  instrument.split_labeled_name(name)[0] == series]
            if hs:
                hsnaps.append((r['t'], instrument.hist_merge(hs)))
        if hsnaps:
            win = instrument.hist_delta(
                hsnaps[-1][1],
                hsnaps[0][1] if len(hsnaps) > 1 else None)
            count = win.get('count', 0)
            return {'kind': 'histogram', 'series': series,
                    'n': len(hsnaps), 'count': count,
                    'mean': (win.get('sum', 0.0) / count)
                    if count else 0.0,
                    'p50': win.get('p50'), 'p95': win.get('p95'),
                    'p99': win.get('p99')}
        return {}

    @staticmethod
    def _scalar(kind, pts):
        vals = [v for _, v in pts]
        return {'kind': kind, 'n': len(pts),
                'mean': sum(vals) / len(vals),
                'min': min(vals), 'max': max(vals), 'last': vals[-1],
                'slope': detector.slope_of(pts)}

    # -- sampler thread ----------------------------------------------------

    def _run(self):
        while not self._stopper.wait(self.every_s):
            try:
                self.sample()
            except Exception:
                _log.warning('mxtpu chronicle: sample failed',
                             exc_info=True)

    def start_thread(self):
        if self._thread is not None:
            return
        self._stopper.clear()
        self._thread = threading.Thread(target=self._run,
                                        name=THREAD_NAME, daemon=True)
        self._thread.start()

    def close(self):
        self._stopper.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with self._wlock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# Module singleton — the env-knob plumbing around one Chronicle
# ---------------------------------------------------------------------------

_chron = None
_lock = threading.Lock()
_atexit_hooked = False


def enabled():
    return _chron is not None


def active():
    """The live :class:`Chronicle` (None when the plane is off)."""
    return _chron


def start(dirpath=None, every_ms=None, max_mb=None, detect=None):
    """Start the plane (idempotent).  ``dirpath`` defaults to the
    MXTPU_CHRONICLE knob; falsy -> no-op None.  Starting implies the
    metrics registry (the plane's input IS the registry) and registers
    the decision sink."""
    global _chron
    with _lock:
        if _chron is not None:
            return _chron
        if dirpath is None:
            dirpath = config.get('MXTPU_CHRONICLE') or None
        if not dirpath:
            return None
        if not instrument.metrics_enabled():
            instrument.set_metrics(True)
        c = Chronicle(dirpath, every_ms=every_ms, max_mb=max_mb,
                      detect=detect)
        instrument.on_decision(c.record_decision)
        c.start_thread()
        _chron = c
        global _atexit_hooked
        if not _atexit_hooked:
            # the sampler reads torch's memory stats: it is stopped and
            # joined before the interpreter finalizes
            _atexit_hooked = True
            atexit.register(stop)
        _log.info('mxtpu chronicle: journaling to %s every %.0fms '
                  '(ring %d MiB, %d detectors)', c.dir,
                  c.every_s * 1000.0, c.max_bytes // (1024 * 1024),
                  len(c.detectors))
        return c


def stop():
    """Stop the sampler thread, unregister the decision sink, and close
    the journal (the active segment stays on disk for the readers)."""
    global _chron
    with _lock:
        c, _chron = _chron, None
    if c is not None:
        instrument.remove_decision_sink(c.record_decision)
        c.close()


def query(series, window_s, now=None):
    """Module-level :meth:`Chronicle.query`; ``{}`` when the plane is
    off — callers need no flag check of their own."""
    c = _chron
    if c is None:
        return {}
    return c.query(series, window_s, now=now)


def refresh():
    """(Re)read MXTPU_CHRONICLE and start the plane when set.  Called
    at import; a single flag check when the knob is empty."""
    if config.get('MXTPU_CHRONICLE'):
        start()


refresh()
