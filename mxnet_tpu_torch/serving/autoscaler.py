"""Closed-loop replica autoscaler — holds the serving p99 at the SLO;
the port of ``mxnet_tpu/serving/autoscaler.py``.

:class:`ReplicaAutoscaler` acts on the serving plane's own histograms:
every ``interval_s`` it reads the WINDOWED p99
(``instrument.HistogramWindow`` deltas of the per-lane/per-replica
``serving.e2e_secs`` series, label-merged model-level), the queued rows
and the windowed shed count, and closes the loop:

- **breach** (windowed p99 over the SLO, sheds in the window, or more
  queued rows than one configured batch) for ``up_after`` consecutive
  ticks: **scale up** one replica (built and, on the card, captured
  before its worker attaches); at ``max_replicas``: **shrink max batch**
  (halve, floor ``min_batch``), or with ``brownout`` climb the ladder —
  shed the batch lane, shrink max batch, smallest bucket only — before
  interactive traffic ever sheds.
- **clear** (windowed p99 under ``down_frac`` x SLO, a near-empty queue,
  no sheds) for ``down_after`` ticks: **restore max batch** first
  (double, back toward the configured cap), then reopen the batch lane,
  then **scale down** one replica.
- **hysteresis**: the consecutive-tick thresholds plus a ``cooldown_s``
  settle window after every action (``detector.HysteresisGate``);
  windows with fewer than ``min_samples`` observations and no backlog
  make no decision at all.

Capacity is counted in replicas, as in the reference: an unsharded
model has no device ceiling (``ModelServer.replica_capacity``), so on
one card the controller climbs to ``max_replicas`` whatever share of
the card each replica adds.

EVERY decision (refusals too) is an event: appended to :attr:`events`
(bounded), an ``instrument.decision('autoscaler', ...)``, counted
(``serving.autoscale.decisions`` and per action), kept in servewatch's
decision ring, and logged.  A scale_up/scale_down runs on a thread of
its own by default (:attr:`async_actuation`): on the card a new replica
captures every bucket while the others replay.  A failed capture is a
logged ``refused`` decision with the real error; no replica ever serves
eagerly.  Decisions serialize with load/unload/reload on the per-model
admin lock inside :class:`~mxnet_tpu_torch.serving.server.ModelServer`.
"""
from __future__ import annotations

import logging
import threading
import time

from .. import config, detector, instrument
from . import servewatch
from .batcher import LANE_BATCH, LANE_INTERACTIVE

__all__ = ['ReplicaAutoscaler']

_log = logging.getLogger('mxnet_tpu_torch.serving')

EVENTS_CAP = 256


class _Watch(object):
    __slots__ = ('model', 'slo_p99_ms', 'min_replicas', 'max_replicas',
                 'min_batch', 'down_frac', 'min_samples', 'gate',
                 'orig_max_batch', 'last_p99_ms',
                 'window', 'shed_prev', 'actuating', 'brownout',
                 'brownout_level')

    def __init__(self, model, slo_p99_ms, min_replicas, max_replicas,
                 min_batch, up_after, down_after, down_frac, cooldown_s,
                 min_samples, brownout=False):
        self.model = model
        self.slo_p99_ms = float(slo_p99_ms)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self.min_batch = max(1, int(min_batch))
        self.down_frac = float(down_frac)
        self.min_samples = max(1, int(min_samples))
        # breach/clear streaks, the post-action cooldown and the
        # settle-window discard all live in the shared gate
        # (mxnet_tpu.detector) — the same machinery the chronicle
        # plane's anomaly detectors run on
        self.gate = detector.HysteresisGate(up_after=up_after,
                                            down_after=down_after,
                                            cooldown_s=cooldown_s)
        self.orig_max_batch = None
        self.last_p99_ms = None
        self.window = instrument.HistogramWindow()
        self.shed_prev = None
        self.actuating = None      # live actuation thread, or None
        # graceful-brownout ladder (only climbed when brownout=True):
        # 0 = none, 1 = batch lane shed, 2 = max_batch shrunk,
        # 3 = smallest bucket only.  Interactive shedding stays the
        # LAST valve.
        self.brownout = bool(brownout)
        self.brownout_level = 0


class ReplicaAutoscaler(object):
    """One controller per :class:`ModelServer`; models enroll via
    :meth:`watch` (or ``server.autoscale``).  The control thread starts
    lazily on the first watch; :meth:`tick` is public so deterministic
    tests (and paused fleets) can step the loop by hand."""

    def __init__(self, server, interval_s=None):
        self._server = server
        self.interval_s = float(
            config.get('MXTPU_SERVE_SCALE_INTERVAL')
            if interval_s is None else interval_s)
        self._watches = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.events = []
        # replica actuation (build + warm on scale_up, drain-join on
        # scale_down) can take minutes on real devices: it runs on a
        # per-decision thread so ONE model's slow actuation cannot
        # stall every other watched model's control loop.  Tests that
        # drive tick() deterministically set this False.
        self.async_actuation = True

    # -- enrollment ---------------------------------------------------------

    def watch(self, model, slo_p99_ms, min_replicas=1, max_replicas=None,
              min_batch=1, up_after=2, down_after=5, down_frac=0.5,
              cooldown_s=None, min_samples=5, start=True,
              brownout=None):
        """Enroll ``model``: hold its windowed p99 at ``slo_p99_ms``
        between ``min_replicas`` and ``max_replicas`` (default
        ``MXTPU_SERVE_MAX_REPLICAS``, clamped to the disjoint-device
        capacity).  ``start=False`` skips the control thread (drive
        :meth:`tick` manually).  ``brownout`` (default
        ``MXTPU_SERVE_BROWNOUT``) enables the graceful degradation
        ladder under sustained breach AT capacity: shed the batch lane
        -> shrink max_batch -> smallest bucket only — interactive
        traffic sheds last, and every rung is a logged, hysteresis-
        gated decision that de-escalates in reverse on clear."""
        if max_replicas is None:
            max_replicas = int(config.get('MXTPU_SERVE_MAX_REPLICAS'))
        if cooldown_s is None:
            cooldown_s = 2.0 * self.interval_s
        if brownout is None:
            brownout = bool(config.get('MXTPU_SERVE_BROWNOUT'))
        w = _Watch(model, slo_p99_ms, min_replicas, max_replicas,
                   min_batch, up_after, down_after, down_frac,
                   cooldown_s, min_samples, brownout=brownout)
        # prime the windows BEFORE publishing the watch: the first tick
        # (possibly from an already-running control thread) must read
        # only traffic that lands after enrollment, never the lifetime
        # aggregate (a slow cold hour must not read as a live breach)
        self._windowed(w)
        with self._lock:
            old = self._watches.get(model)
            if old is not None:
                # re-enrolling (SLO change) must not forget the
                # CONFIGURED batch cap: a currently-shrunk max_batch
                # would otherwise be recorded as the 'original' and
                # never restored past it — nor the brownout rung the
                # fleet currently sits on (the shed-lane flag lives in
                # the batcher and survives re-enrollment)
                w.orig_max_batch = old.orig_max_batch
                w.brownout_level = old.brownout_level
            self._watches[model] = w
        if start:
            self.start()
        return w

    def unwatch(self, model):
        with self._lock:
            had = self._watches.pop(model, None) is not None
        if had:
            instrument.drop_metric('serving.autoscale.p99_ms|model=%s'
                                   % model)

    def watched(self):
        with self._lock:
            return sorted(self._watches)

    # -- control thread -----------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is not None or self.interval_s <= 0:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name='mxtpu-torch-serve-autoscaler',
                daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=10)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:         # noqa: BLE001 - controller survives
                _log.exception('mxtpu autoscaler tick failed')

    # -- the control law ----------------------------------------------------

    def _windowed(self, w):
        """(p99_ms, samples, shed_delta) of the model's LAST window:
        the per-lane/per-replica e2e series label-merged model-level
        (names parsed with the registry's one label convention —
        ``instrument.split_labeled_name`` — not substring-matched)."""
        merged = w.window.merged_delta_labeled('serving.e2e_secs|',
                                               model=w.model)
        shed = 0
        for lane in (LANE_BATCH, LANE_INTERACTIVE):
            shed += int(instrument.counter_value(
                'serving.shed_total|model=%s,lane=%s' % (w.model, lane)))
        delta = shed - (w.shed_prev if w.shed_prev is not None else shed)
        w.shed_prev = shed
        return 1e3 * merged.get('p99', 0.0), int(merged.get('count', 0)), \
            max(0, delta)

    def tick(self):
        """One control step over every watched model.  Returns the list
        of decision events this tick emitted.  Per-model failures are
        isolated: one model racing its own unload cannot starve the
        other watched models of their hysteresis progress."""
        with self._lock:
            watches = list(self._watches.values())
        out = []
        for w in watches:
            try:
                ev = self._tick_model(w)
            except Exception:     # noqa: BLE001 - logged, next model
                _log.exception('mxtpu autoscaler: tick for %r '
                                  'failed', w.model)
                continue
            if ev is not None:
                out.append(ev)
        return out

    def _tick_model(self, w):
        server = self._server
        entry = server._models.get(w.model)
        if entry is None or entry.closed:
            self.unwatch(w.model)
            return self._event(w, 'unwatch', 'model unloaded',
                               p99_ms=None, replicas=0)
        batcher = entry.batcher
        if w.orig_max_batch is None:
            # the CONFIGURED cap, not the live value: enrolling while a
            # previous controller's shrink is still in effect must not
            # lower the restore target
            w.orig_max_batch = getattr(batcher, 'configured_max_batch',
                                       batcher.max_batch)
        p99_ms, samples, shed = self._windowed(w)
        w.last_p99_ms = p99_ms if samples >= w.min_samples else None
        qd = batcher.depth()
        # backlog thresholds speak ROWS (max_batch's unit — a request
        # may carry many), against the CONFIGURED cap so a transiently
        # shrunk max_batch cannot turn routine queueing into a
        # perpetual breach
        qrows = batcher.queued_rows()
        cap_rows = getattr(batcher, 'configured_max_batch',
                           batcher.max_batch)
        replicas = len(entry.replicas)
        if samples >= w.min_samples:
            instrument.set_gauge('serving.autoscale.p99_ms|model=%s'
                                 % w.model, p99_ms)
        else:
            # a thin window is NO DATA, not a perfect 0ms p99 — drop
            # the gauge so an idle model scrapes as absent
            instrument.drop_metric('serving.autoscale.p99_ms|model=%s'
                                   % w.model)
        if samples < w.min_samples and shed == 0 and qrows <= cap_rows:
            # thin window AND no backlog: no evidence, no decision (and
            # no hysteresis progress in either direction).  A backlog
            # past one configured batch is evidence even when few
            # requests COMPLETED in the window — a replica slow enough
            # to starve the completion count must still trigger the
            # breach path below
            return None
        act = w.actuating
        if act is not None:
            if act.is_alive():
                # an actuation (replica build + warm, or drain-join) is
                # still in flight on its own thread: keep consuming
                # windows but make no further decisions for this model
                w.gate.reset()
                return None
            w.actuating = None
        breach = (samples >= w.min_samples and p99_ms > w.slo_p99_ms) \
            or shed > 0 or qrows > cap_rows
        clear = samples >= w.min_samples and shed == 0 and \
            p99_ms < w.down_frac * w.slo_p99_ms and \
            qrows <= max(1, cap_rows // 4)
        # the gate owns the hysteresis discipline: the settle window
        # after an action discards pre-action stragglers with no streak
        # progress, mixed evidence resets both streaks, and a verdict
        # only lands after up_after/down_after consecutive windows
        verdict = w.gate.observe(breach, clear)
        if verdict == 'breach':
            return self._act_up(w, entry, batcher, p99_ms, qd, shed,
                                replicas)
        if verdict == 'clear':
            return self._act_down(w, entry, batcher, p99_ms, qd,
                                  replicas)
        return None

    def _scale_up_refusal(self, w, entry, p99_ms, replicas, max_batch,
                          qd, exc=None):
        """The follow-up event when scale_up failed or returned None —
        shared by the sync path and the async actuation thread, so
        both log the REAL reason (build failure vs capacity vs an
        unload racing the decision), never a capacity excuse."""
        if exc is not None:
            return self._event(w, 'refused', 'scale_up failed: %s'
                               % exc, p99_ms=p99_ms, replicas=replicas,
                               max_batch=max_batch, queue_depth=qd)
        if self._server._models.get(w.model) is not entry or \
                entry.closed:
            self.unwatch(w.model)
            return self._event(w, 'unwatch',
                               'model unloaded mid-decision',
                               p99_ms=p99_ms, replicas=replicas)
        return self._event(w, 'refused',
                           'scale_up found no disjoint device set',
                           p99_ms=p99_ms, replicas=replicas,
                           max_batch=max_batch, queue_depth=qd)

    def _act_up(self, w, entry, batcher, p99_ms, qd, shed, replicas):
        server = self._server
        cap = min(w.max_replicas, server._capacity_for(entry))
        if replicas < cap:
            reason = ('windowed p99 %.1fms > SLO %.1fms (shed %d, '
                      'queue %d)' % (p99_ms, w.slo_p99_ms, shed, qd))
            if self.async_actuation:
                # the build+warm can take minutes on real devices: run
                # it on its own thread (the tick gate above holds this
                # model's decisions until it lands) so other watched
                # models keep their control loop
                def act():
                    try:
                        n = server.scale_up(w.model)
                    except Exception as e:  # noqa: BLE001 - logged
                        self._scale_up_refusal(w, entry, p99_ms,
                                               replicas,
                                               batcher.max_batch, qd,
                                               exc=e)
                        return
                    if n is None:
                        self._scale_up_refusal(w, entry, p99_ms,
                                               replicas,
                                               batcher.max_batch, qd)
                t = threading.Thread(
                    target=act, daemon=True,
                    name='mxtpu-torch-serve-scale-%s' % w.model)
                w.actuating = t
                t.start()
                return self._done(w, 'scale_up', reason + '; actuating',
                                  p99_ms, replicas + 1,
                                  batcher.max_batch, qd)
            try:
                n = server.scale_up(w.model)
            except Exception as e:     # noqa: BLE001 - logged verbatim
                # a genuine build failure (missing checkpoint, stale
                # builder source after a prebuilt reload) — log the
                # REAL reason, not a capacity excuse
                return self._done(w, 'refused', 'scale_up failed: %s'
                                  % e, p99_ms, replicas,
                                  batcher.max_batch, qd)
            if n is not None:
                return self._done(w, 'scale_up', reason, p99_ms, n,
                                  batcher.max_batch, qd)
            w.gate.acted()
            return self._scale_up_refusal(w, entry, p99_ms, replicas,
                                          batcher.max_batch, qd)
        # at capacity: with brownout on, degrade in the DOCUMENTED
        # order — shed the batch lane, shrink max_batch, smallest
        # bucket only — before interactive traffic ever sheds.  Each
        # rung is one hysteresis-gated decision (breach streak + the
        # post-action cooldown), so the ladder climbs one step per
        # sustained breach, never all at once.
        if w.brownout and not batcher.shed_batch:
            batcher.shed_batch = True
            self._set_level(w, 1)
            return self._done(w, 'brownout',
                              'at capacity (%d replicas): level 1 — '
                              'shedding the batch lane to keep '
                              'interactive capacity' % replicas,
                              p99_ms, replicas, batcher.max_batch, qd,
                              level=1)
        if batcher.max_batch > w.min_batch:
            batcher.max_batch = max(w.min_batch, batcher.max_batch // 2)
            if w.brownout:
                self._set_level(w, 2)
                return self._done(w, 'brownout',
                                  'level 2 — halving max batch to %d '
                                  'to cut coalescing tail'
                                  % batcher.max_batch,
                                  p99_ms, replicas, batcher.max_batch,
                                  qd, level=2)
            return self._done(w, 'shrink_batch',
                              'at max replicas (%d); halving max batch '
                              'to %d to cut coalescing tail'
                              % (replicas, batcher.max_batch),
                              p99_ms, replicas, batcher.max_batch, qd)
        if w.brownout and w.brownout_level < 3:
            self._set_level(w, 3)
            return self._done(w, 'brownout',
                              'level 3 — at min batch (%d): smallest '
                              'bucket only; interactive shedding is '
                              'the last valve' % batcher.max_batch,
                              p99_ms, replicas, batcher.max_batch, qd,
                              level=3)
        return self._done(w, 'refused',
                          'at max replicas (%d) and min batch (%d): '
                          'capacity exhausted — shedding is the relief '
                          'valve' % (replicas, batcher.max_batch),
                          p99_ms, replicas, batcher.max_batch, qd)

    def _act_down(self, w, entry, batcher, p99_ms, qd, replicas):
        server = self._server
        if w.orig_max_batch and batcher.max_batch < w.orig_max_batch:
            # de-escalation mirrors the ladder in reverse: buckets
            # restore first, the shed lane reopens next, replicas
            # scale down last
            batcher.max_batch = min(w.orig_max_batch,
                                    batcher.max_batch * 2)
            if w.brownout_level >= 2 and \
                    batcher.max_batch >= w.orig_max_batch:
                self._set_level(w, 1 if batcher.shed_batch else 0)
            return self._done(w, 'restore_batch',
                              'p99 %.1fms well under SLO: restoring '
                              'max batch to %d'
                              % (p99_ms, batcher.max_batch),
                              p99_ms, replicas, batcher.max_batch, qd)
        if batcher.shed_batch:
            batcher.shed_batch = False
            self._set_level(w, 0)
            return self._done(w, 'brownout',
                              'p99 %.1fms recovered: reopening the '
                              'batch lane (level 0)' % p99_ms,
                              p99_ms, replicas, batcher.max_batch, qd,
                              level=0)
        if replicas > w.min_replicas:
            reason = ('p99 %.1fms under %.0f%% of SLO for %d windows'
                      % (p99_ms, 100 * w.down_frac, w.gate.down_after))
            if self.async_actuation:
                # the drain-join can block up to the worker timeout:
                # actuate off-thread like scale_up — with the same
                # follow-up logging, so a refused/failed removal is a
                # logged event, not a silent divergence from the log
                def act():
                    try:
                        n = server.scale_down(w.model)
                    except Exception as e:  # noqa: BLE001 - logged
                        self._event(w, 'refused',
                                    'scale_down failed: %s' % e,
                                    p99_ms=p99_ms, replicas=replicas,
                                    max_batch=batcher.max_batch,
                                    queue_depth=qd)
                        return
                    if n is None:
                        self._event(w, 'refused',
                                    'scale_down was a no-op (model '
                                    'unloaded or already at one '
                                    'replica)', p99_ms=p99_ms,
                                    replicas=replicas,
                                    max_batch=batcher.max_batch,
                                    queue_depth=qd)
                t = threading.Thread(
                    target=act, daemon=True,
                    name='mxtpu-torch-serve-scale-%s' % w.model)
                w.actuating = t
                t.start()
                return self._done(w, 'scale_down',
                                  reason + '; actuating', p99_ms,
                                  replicas - 1, batcher.max_batch, qd)
            n = server.scale_down(w.model)
            if n is not None:
                return self._done(w, 'scale_down', reason, p99_ms, n,
                                  batcher.max_batch, qd)
            # a no-op (model unloaded or already at one replica) is a
            # decision too: log it and take the cooldown, mirroring
            # the async path — silent fall-through would re-attempt
            # every tick with the event log diverging from reality
            w.gate.acted()
            return self._event(w, 'refused',
                               'scale_down was a no-op (model '
                               'unloaded or already at one replica)',
                               p99_ms=p99_ms, replicas=replicas,
                               max_batch=batcher.max_batch,
                               queue_depth=qd)
        return None

    # -- decision logging ---------------------------------------------------

    def _set_level(self, w, level):
        w.brownout_level = int(level)
        instrument.set_gauge('serving.brownout_level|model=%s'
                             % w.model, w.brownout_level)

    def _done(self, w, action, reason, p99_ms, replicas, max_batch, qd,
              **extra):
        w.gate.acted()
        return self._event(w, action, reason, p99_ms=p99_ms,
                           replicas=replicas, max_batch=max_batch,
                           queue_depth=qd, **extra)

    def _event(self, w, action, reason, p99_ms=None, replicas=None,
               max_batch=None, queue_depth=None, **extra):
        ev = {'t': time.time(), 'model': w.model, 'action': action,
              'reason': reason, 'p99_ms': p99_ms,
              'slo_p99_ms': w.slo_p99_ms, 'replicas': replicas,
              'max_batch': max_batch, 'queue_depth': queue_depth}
        if extra:
            ev.update(extra)
        self.events.append(ev)
        del self.events[:-EVENTS_CAP]
        # the request-attribution plane keeps its own bounded ring so a
        # tail postmortem can name every decision inside its request's
        # window (single flag check when the plane is off)
        servewatch.note_decision(ev)
        # the unified decision timeline: every autoscale action (and
        # refusal) is a typed decision event the chronicle journals
        instrument.decision('autoscaler', action, reason=reason,
                            model=w.model, p99_ms=p99_ms,
                            replicas=replicas, max_batch=max_batch,
                            queue_depth=queue_depth)
        instrument.inc('serving.autoscale.decisions')
        instrument.inc('serving.autoscale.%s' % action)
        if instrument.profiling_enabled():
            instrument.record_complete(
                'serving.autoscale[%s]' % w.model,
                int(time.time_ns() // 1000), 0, cat='serving',
                args={'action': action, 'reason': reason,
                      'p99_ms': p99_ms, 'replicas': replicas})
        _log.info(
            'autoscale %s: %s — %s (p99 %.1fms / SLO %.1fms, '
            'replicas %s, max_batch %s)', w.model, action, reason,
            p99_ms if p99_ms is not None else float('nan'),
            w.slo_p99_ms, replicas, max_batch)
        return ev
