"""Request-attribution plane — per-request tracing, tail-latency
forensics and SLO budget accounting through the serving fleet; the port
of ``mxnet_tpu/serving/servewatch.py``.

1. **Per-request trace propagation** — every admitted request gets a
   request id (``<model>-<seq>``, also attached to its Future as
   ``req_id``); its life is an EXCLUSIVE bucket span chain::

       admission_wait -> lane_wait -> coalesce_wait -> pad -> execute
                      -> slice_deliver

   recorded as ``serving.req.<bucket>_secs`` labeled histograms (per
   model/lane/replica) and, under profiling, as ``serve.req.<bucket>``
   trace spans correlated by request id.  The six buckets are boundary
   differences of ONE timestamp chain, so they sum to the e2e span
   exactly.  The queue interval between admission and flush assembly is
   split by attribution: ``coalesce_wait`` is the part bounded by the
   batching knob (at most ``max_delay``), ``lane_wait`` the excess (no
   worker was free).  On the card ``execute`` ends when the replica's
   output has been copied to the host (the copy waits on the replica's
   stream), so it holds the device time and ``slice_deliver`` does not.
   Every flush also records its COMPOSITION (a ``serve.flush`` span and
   a bounded ring): peer request ids, lane, pow2 bucket, pad-waste rows,
   replica slot and the executable signature.

2. **Tail forensics** — a request breaching MXTPU_SERVE_TRACE_SLOW_MS
   (or shed, errored, replayed or deadline-dropped) commits a durable
   flight-record postmortem (``health.FlightRecorder``) naming its span
   chain, the flush it rode, the queue depths at admission and every
   autoscaler decision inside its window.  Latency histograms carry
   EXEMPLARS (the last request id per ``le=`` bucket, in snapshots and
   in the Prometheus exposition).  Postmortems are capped per process
   (MXTPU_SERVE_POSTMORTEM_CAP; ``serving.postmortems_dropped``).  They
   are written on the delivering replica's worker thread, as in the
   reference.

3. **SLO budget tables** — :func:`budget_tables` folds the
   ``serving.req.*`` histograms into per-(model, lane, replica) tables.

Off, every hook is one module-global check; on, the plane spawns no
threads.  ``MXTPU_SERVEWATCH=1`` implies the metrics registry.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from .. import config, health, instrument

__all__ = [
    'enabled', 'set_enabled', 'refresh',
    'slow_ms', 'set_slow_ms', 'set_postmortem_cap',
    'BUCKETS', 'next_request_id',
    'admit', 'note_shed', 'note_decision', 'note_deadline',
    'note_supervision', 'supervision_events',
    'open_flush', 'deliver', 'close_flush', 'note_error',
    'flushes', 'decisions', 'postmortems', 'postmortem_for',
    'budget_tables', 'reset',
]

# The exclusive span-chain buckets, in CHAIN ORDER (boundary i..i+1 of
# one per-request timestamp chain — they sum to e2e by construction).
# tools/explain_request.py and tools/check_trace.py mirror this tuple.
BUCKETS = ('admission_wait', 'lane_wait', 'coalesce_wait', 'pad',
           'execute', 'slice_deliver')

_on = False
_slow_s = 0.0
_cap = 64

_seq = itertools.count(1)
_flush_seq = itertools.count(1)

_lock = threading.Lock()
_flushes = deque(maxlen=256)       # recent flush composition records
_decisions = deque(maxlen=512)     # recent autoscaler decision events
_supervision = deque(maxlen=256)   # recent supervisor repair events
_sup_state = {}                    # model -> latest {rid: state}
_postmortems = deque(maxlen=256)   # committed postmortem registry
_written = 0                       # postmortems committed (cap gate)


# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------

def refresh():
    """(Re)read the MXTPU_SERVEWATCH / MXTPU_SERVE_TRACE_SLOW_MS /
    MXTPU_SERVE_POSTMORTEM_CAP knobs.  Called at import; hot-path hooks
    read the cached module globals only."""
    global _on, _slow_s, _cap
    _on = bool(config.get('MXTPU_SERVEWATCH'))
    _slow_s = float(config.get('MXTPU_SERVE_TRACE_SLOW_MS')) / 1e3
    _cap = int(config.get('MXTPU_SERVE_POSTMORTEM_CAP'))
    if _on and not instrument.metrics_enabled():
        # the plane's output IS the metrics registry — implied on, the
        # same contract as MXTPU_PROFILE / MXTPU_PERFWATCH
        instrument.set_metrics(True)


def set_enabled(on):
    """Runtime toggle (tests, check_fleet legs; equivalent to
    exporting MXTPU_SERVEWATCH)."""
    global _on
    _on = bool(on)
    if _on and not instrument.metrics_enabled():
        instrument.set_metrics(True)


def enabled():
    return _on


def slow_ms():
    return _slow_s * 1e3


def set_slow_ms(ms):
    """Runtime override of the tail-forensics threshold."""
    global _slow_s
    _slow_s = float(ms) / 1e3


def set_postmortem_cap(n):
    global _cap
    _cap = int(n)


def reset():
    """Drop the in-process rings and the postmortem cap accounting
    (tests).  Does not touch the metrics registry."""
    global _written
    with _lock:
        _flushes.clear()
        _decisions.clear()
        _supervision.clear()
        _sup_state.clear()
        _postmortems.clear()
        _written = 0


# ---------------------------------------------------------------------------
# Admission side (called by batcher.submit, under the batcher lock)
# ---------------------------------------------------------------------------

def next_request_id(model):
    """``<model>-<seq>``: process-unique, human-greppable, and legal
    in flight-record filenames (model names are already restricted to
    ``[A-Za-z0-9._:-]`` by ModelServer.load_model)."""
    return '%s-%d' % (model, next(_seq))


def admit(req, model, lane_depth, total_depth):
    """Stamp one admitted request: id, admission timestamp, and the
    queue/lane depths it saw (the postmortem's admission context).
    ``req.t_submit`` was stamped at submit() entry by the batcher —
    admission_wait covers validation + lock acquisition."""
    req.req_id = next_request_id(model)
    req.t_admit = time.monotonic()
    req.admit_depths = (lane_depth, total_depth)
    req.future.req_id = req.req_id


def note_shed(model, lane, lane_depth, total_depth):
    """A request was shed at admission: commit a (capped) postmortem —
    a shed IS the tail event for its client."""
    if not _on:
        return None
    rid = next_request_id(model)
    return _commit_postmortem(rid, {
        'req_id': rid, 'kind': 'shed', 'model': model, 'lane': lane,
        'admission': {'lane_depth': lane_depth,
                      'queue_depth': total_depth},
        'autoscaler_events': _decisions_between(time.time() - 1.0,
                                                time.time()),
    })


# ---------------------------------------------------------------------------
# Autoscaler decisions (called by autoscaler._event)
# ---------------------------------------------------------------------------

def note_decision(ev):
    """Remember one autoscaler decision event (bounded ring) so a
    postmortem can name every decision inside its request's window."""
    if _on:
        with _lock:
            _decisions.append(dict(ev))


def decisions():
    with _lock:
        return list(_decisions)


def _decisions_between(w0, w1):
    with _lock:
        return [dict(ev) for ev in _decisions
                if w0 <= float(ev.get('t') or 0.0) <= w1]


# ---------------------------------------------------------------------------
# Supervision events (called by supervisor._event)
# ---------------------------------------------------------------------------

def note_supervision(ev, state=None):
    """Remember one supervisor repair event (bounded ring) plus the
    model's latest replica-state map, so a replayed or deadline-dropped
    request's postmortem can name the quarantine that displaced it."""
    if _on:
        with _lock:
            _supervision.append(dict(ev))
            if state is not None and ev.get('model') is not None:
                _sup_state[ev['model']] = dict(state)


def supervision_events():
    with _lock:
        return [dict(e) for e in _supervision]


def _supervision_context(model):
    """(latest quarantine event for ``model``, latest replica-state
    map) — the forensic link from a replayed/expired request back to
    the repair that displaced it.  Caller does NOT hold _lock."""
    with _lock:
        quarantine = None
        for e in reversed(_supervision):
            if e.get('model') == model and \
                    e.get('action') == 'quarantine':
                quarantine = dict(e)
                break
        return quarantine, dict(_sup_state.get(model) or {})


def note_deadline(model, req, now):
    """A request's deadline passed while it was still queued: commit a
    (capped) postmortem naming the wait, the admission context, and
    the supervision state — a deadline drop IS the tail event for its
    client.  NO latency histograms: expired requests are exempt from
    the SLO series the autoscaler steers on, like errors."""
    if not _on or getattr(req, 'req_id', None) is None:
        return None
    depths = getattr(req, 'admit_depths', (None, None))
    waited = now - req.t_enqueue
    w1 = time.time()
    quarantine, state = _supervision_context(model)
    return _commit_postmortem(req.req_id, {
        'req_id': req.req_id, 'kind': 'deadline',
        'model': model, 'lane': req.lane, 'rows': req.rows,
        'waited_ms': 1e3 * waited,
        'deadline_ms': (1e3 * (req.deadline - req.t_enqueue)
                        if req.deadline is not None else None),
        'replayed': bool(getattr(req, 'replayed', False)),
        'quarantine': quarantine,
        'supervision': {'state': state},
        'admission': {'lane_depth': depths[0],
                      'queue_depth': depths[1]},
        'autoscaler_events': _decisions_between(w1 - waited - 1.0, w1),
    })


# ---------------------------------------------------------------------------
# Flush side (called by batcher._flush on the replica worker thread)
# ---------------------------------------------------------------------------

def open_flush(model, lane, replica, batch, rows, max_delay,
               t_taken, t_exec0, t_exec1, execute):
    """Build one flush's composition record (peer ids, pow2 bucket,
    pad waste, executable signature) and register it in the bounded
    ring.  Returns the record; :func:`deliver` then finishes each
    request against it and :func:`close_flush` emits the ``serve.flush``
    composition span covering taken->last-delivery."""
    info = getattr(execute, 'last_info', None)
    bucket = info[0] if info else None
    now_mono = time.monotonic()
    rec = {
        'id': '%s-f%d' % (model, next(_flush_seq)),
        'model': model, 'lane': lane, 'replica': replica,
        'rows': rows, 'requests': len(batch),
        'req_ids': [getattr(r, 'req_id', None) for r in batch],
        'bucket': bucket,
        'pad_waste': (bucket - rows) if bucket else None,
        'sig': info[1] if info else None,
        'max_delay': max_delay,
        't_taken': t_taken, 't_exec0': t_exec0, 't_exec1': t_exec1,
        't_last': t_exec1,
        # monotonic -> trace-clock (wall us) offset, computed ONCE per
        # flush so every span of this flush shares one conversion and
        # the us-rounded boundaries stay monotone across spans
        'us_off': time.time_ns() // 1000 - int(round(now_mono * 1e6)),
        'wall_off': time.time() - now_mono,
    }
    with _lock:
        _flushes.append({k: rec[k] for k in
                         ('id', 'model', 'lane', 'replica', 'rows',
                          'requests', 'req_ids', 'bucket', 'pad_waste',
                          'sig')})
    return rec


def _us(rec, t):
    return rec['us_off'] + int(round(t * 1e6))


def deliver(rec, req, t_done):
    """Finish one delivered request against its flush: bucket
    histograms, trace spans, and — on a threshold breach — the
    postmortem.  Requests admitted before the plane was enabled carry
    no stamps and are skipped."""
    if getattr(req, 'req_id', None) is None:
        return
    rec['t_last'] = t_done
    _finish_request(rec, req, t_done, error=None)


def close_flush(rec):
    """Emit the flush composition span (taken -> last delivery) once
    every request of the flush was delivered."""
    if not instrument.profiling_enabled():
        return
    ts = _us(rec, rec['t_taken'])
    instrument.record_complete(
        'serve.flush', ts, max(0, _us(rec, rec['t_last']) - ts),
        cat='serving',
        args={'flush': rec['id'], 'model': rec['model'],
              'lane': rec['lane'], 'replica': rec['replica'],
              'rows': rec['rows'], 'requests': rec['requests'],
              'req_ids': rec['req_ids'], 'bucket': rec['bucket'],
              'pad_waste': rec['pad_waste'], 'sig': rec['sig']})


def note_error(model, lane, replica, batch, max_delay, t_taken,
               t_exec0, exc):
    """The whole flush failed: finish each stamped request with a
    truncated chain (execute ends at the error instant,
    slice_deliver = 0) and commit error postmortems (capped).  No
    latency histograms — a failed request must not pollute the SLO
    series the autoscaler steers on."""
    rec = open_flush(model, lane, replica, batch,
                     sum(r.rows for r in batch), max_delay,
                     t_taken, t_exec0, time.monotonic(), execute=None)
    t_err = time.monotonic()
    rec['t_last'] = t_err
    for req in batch:
        if getattr(req, 'req_id', None) is None:
            continue
        _finish_request(rec, req, t_err, error=str(exc))
    close_flush(rec)


def _finish_request(rec, req, t_done, error=None):
    # ONE timestamp chain; each bucket is a boundary difference, so the
    # six buckets telescope to e2e exactly.  The admit->taken queue
    # interval is split by attribution: coalesce_wait is the policy-
    # bounded part (<= max_delay, the knob's price), lane_wait the
    # excess (worker starvation).  Chain order follows BUCKETS.
    t_sub = req.t_submit
    t_adm = max(req.t_admit, t_sub)
    t_taken = max(rec['t_taken'], t_adm)
    wait = t_taken - t_adm
    coalesce = min(wait, rec['max_delay'])
    bounds = [t_sub, t_adm, t_adm + (wait - coalesce), t_taken,
              max(rec['t_exec0'], t_taken),
              max(rec['t_exec1'], rec['t_exec0'], t_taken),
              t_done]
    for i in range(1, len(bounds)):
        if bounds[i] < bounds[i - 1]:
            bounds[i] = bounds[i - 1]
    rid = req.req_id
    model, lane, replica = rec['model'], rec['lane'], rec['replica']
    secs = [bounds[i + 1] - bounds[i] for i in range(len(BUCKETS))]
    e2e = t_done - t_sub

    if error is None:
        names = _bucket_names(model, lane, replica)
        for name, s in zip(names, secs):
            instrument.observe_hist(name, s)
        instrument.observe_hist(names[-1], e2e, exemplar=rid)

    if instrument.profiling_enabled():
        us = [_us(rec, b) for b in bounds]
        for i in range(1, len(us)):       # keep us-rounded chain monotone
            if us[i] < us[i - 1]:
                us[i] = us[i - 1]
        args = {'req': rid, 'flush': rec['id'], 'model': model,
                'lane': lane, 'replica': replica}
        for i, bucket in enumerate(BUCKETS):
            instrument.record_complete(
                'serve.req.%s' % bucket, us[i], us[i + 1] - us[i],
                cat='serving', args=args)
        instrument.record_complete(
            'serve.request', us[0], us[-1] - us[0], cat='serving',
            args=dict(args, rows=req.rows,
                      error=error) if error is not None
            else dict(args, rows=req.rows))

    slow = _slow_s > 0 and e2e > _slow_s
    replayed = bool(getattr(req, 'replayed', False))
    if error is not None or slow or replayed:
        depths = getattr(req, 'admit_depths', (None, None))
        w0 = rec['wall_off'] + t_sub
        w1 = rec['wall_off'] + t_done
        buckets_ms = {b: 1e3 * s for b, s in zip(BUCKETS, secs)}
        payload = {
            'req_id': rid,
            'kind': ('error' if error is not None
                     else 'slow' if slow else 'replayed'),
            'error': error,
            'model': model, 'lane': lane, 'replica': replica,
            'rows': req.rows,
            'e2e_ms': 1e3 * e2e,
            'slow_ms': _slow_s * 1e3 if _slow_s > 0 else None,
            'buckets_ms': buckets_ms,
            'dominant': max(BUCKETS, key=lambda b: buckets_ms[b]),
            'flush': {k: rec[k] for k in
                      ('id', 'req_ids', 'rows', 'requests', 'bucket',
                       'pad_waste', 'sig')},
            'admission': {'lane_depth': depths[0],
                          'queue_depth': depths[1]},
            'autoscaler_events': _decisions_between(w0, w1),
        }
        if replayed:
            # the request survived a quarantine: name the repair that
            # displaced it (replay hop) and the supervision state, so
            # explain_request can render replica-A -> quarantine ->
            # replica-B in the waterfall
            quarantine, state = _supervision_context(model)
            payload['replayed'] = True
            payload['quarantine'] = quarantine
            payload['supervision'] = {'state': state}
        _commit_postmortem(rid, payload)


_names_lock = threading.Lock()
_names = {}      # (model, lane, replica) -> labeled histogram names


def _bucket_names(model, lane, replica):
    key = (model, lane, replica)
    names = _names.get(key)
    if names is None:
        suffix = '|lane=%s,model=%s,replica=%s' % (lane, model, replica)
        with _names_lock:
            names = _names.setdefault(key, tuple(
                'serving.req.%s_secs%s' % (b, suffix)
                for b in BUCKETS + ('e2e',)))
    return names


# ---------------------------------------------------------------------------
# Postmortems
# ---------------------------------------------------------------------------

def _commit_postmortem(rid, payload):
    """Commit one durable flight-record postmortem (capped).  Returns
    the durable path, or None when capped / no recorder could be
    installed (MXTPU_FLIGHT_RECORDER unset)."""
    global _written
    with _lock:
        if _written >= _cap:
            instrument.inc('serving.postmortems_dropped')
            return None
        _written += 1
    rec = health.flight_recorder()
    if rec is None:
        rec = health.install_flight_recorder()
    if rec is None:
        # no recorder and no MXTPU_FLIGHT_RECORDER dir to install one:
        # keep the in-process registry entry so serve_bench / the
        # advisor still link request -> forensics summary
        instrument.inc('serving.postmortems_skipped')
        path = None
    else:
        reason = 'serve-%s' % rid
        rec.dump(reason, extra=payload)
        path = rec.durable_path(reason)
        instrument.inc('serving.postmortems')
    entry = {'req_id': rid, 'path': path,
             'kind': payload.get('kind'),
             'model': payload.get('model'),
             'replica': payload.get('replica'),
             'dominant': payload.get('dominant')}
    with _lock:
        _postmortems.append(entry)
    return path


def postmortems():
    """Registry of committed postmortems (bounded): dicts of
    req_id/path/kind/model/replica/dominant."""
    with _lock:
        return [dict(p) for p in _postmortems]


def postmortem_for(req_id):
    with _lock:
        for p in reversed(_postmortems):
            if p['req_id'] == req_id:
                return dict(p)
    return None


def flushes():
    """Recent flush composition records (bounded ring)."""
    with _lock:
        return [dict(f) for f in _flushes]


# ---------------------------------------------------------------------------
# Budget tables
# ---------------------------------------------------------------------------

def budget_tables(snapshot=None):
    """Fold the ``serving.req.*`` labeled histograms into
    per-(model, lane, replica) SLO budget tables::

        {(model, lane, replica): {bucket: {'sum': s, 'count': n}, ...,
                                  'e2e': {...}}}

    The in-process view behind ``tools/explain_request.py`` (which
    re-implements the fold framework-import-free for offline
    snapshots).  Bucket sums obey the exclusivity discipline: they add
    up to the e2e sum (within float rounding), so shares are honest
    fractions of the request's life."""
    snap = instrument.metrics_snapshot() if snapshot is None \
        else snapshot
    tables = {}
    for name, h in (snap.get('histograms') or {}).items():
        base, labels = instrument.split_labeled_name(name)
        if not labels or not base.startswith('serving.req.') \
                or not base.endswith('_secs'):
            continue
        bucket = base[len('serving.req.'):-len('_secs')]
        key = (labels.get('model'), labels.get('lane'),
               labels.get('replica'))
        tables.setdefault(key, {})[bucket] = {
            'sum': float((h or {}).get('sum', 0.0)),
            'count': int((h or {}).get('count', 0))}
    return tables


refresh()
