"""Replica supervision — the serving fleet's detect→repair loop, the
port of ``mxnet_tpu/serving/supervisor.py``.

:class:`FleetSupervisor` reads, every ``interval_s``, each watched
model's flush-progress heartbeats (``DynamicBatcher.inflight_ages``: a
worker idle on an empty queue has no entry and is healthy) and worker
obituaries (``dead_workers``), and repairs two failure shapes:

- **wedged**: a replica mid-flush with no progress past ``wedge_ms`` (a
  hung forward, a stuck copy).  The worker thread cannot be killed, so
  it is QUARANTINED: detached without a join, its in-flight batch
  seized, so if it ever wakes it delivers nothing.
- **dead**: a worker that died of an exception outside a flush's own
  error handling (an injected :class:`~mxnet_tpu_torch.resilience
  .InjectedDeath` at the ``serve.worker`` site too).

Quarantine order, all under the model's ADMIN lock (no scale decision,
reload or unload can race the repair):

1. seize the in-flight batch; drop the replica from the entry and its
   labeled series from the registry;
2. re-queue the seized requests at the HEAD of their lane, once each
   (``DynamicBatcher.requeue_head``); an already-replayed request fails
   with :class:`ReplicaQuarantinedError` instead of looping;
3. build and warm (on the card: capture every bucket of) a REPLACEMENT
   through ``scale_up`` BEFORE tearing the quarantined replica down,
   and protect it from ``scale_down`` for a grace window;
4. detach the quarantined worker (its slot stays busy while the wedged
   thread lives).

Every transition is a logged event (:attr:`events`), an
``instrument.decision('supervisor', ...)``, an entry of servewatch's
supervision ring, and counted (``serving.quarantines``,
``serving.replays``, the ``serving.replica_recovery_secs`` gauge).
Nothing runs unless a model is watched (``ModelServer.supervise`` or
``MXTPU_SERVE_SUPERVISE=1``).
"""
from __future__ import annotations

import logging
import threading
import time

from .. import config, instrument
from . import servewatch
from .batcher import ReplicaQuarantinedError

__all__ = ['FleetSupervisor']

EVENTS_CAP = 256

_log = logging.getLogger('mxnet_tpu_torch.serving')


class _SupWatch(object):
    __slots__ = ('model', 'wedge_s', 'states', 'protected')

    def __init__(self, model, wedge_s):
        self.model = model
        self.wedge_s = float(wedge_s)
        # rid -> 'wedged' | 'dead' | 'quarantined' | 'replacing';
        # replicas absent from this map are healthy
        self.states = {}
        # replacement rid -> protection deadline (monotonic): until it
        # passes, scale_down must not pick this replica — the repair
        # must not be immediately undone by a clear window
        self.protected = {}


class FleetSupervisor(object):
    """One supervisor per :class:`ModelServer`; models enroll via
    :meth:`watch` (or ``server.supervise`` / ``MXTPU_SERVE_SUPERVISE``).
    The poll thread starts lazily on the first watch; :meth:`tick` is
    public so deterministic tests step the loop by hand
    (``interval_s <= 0`` never starts a thread at all)."""

    def __init__(self, server, interval_s=None):
        self._server = server
        self.interval_s = float(
            config.get('MXTPU_SERVE_SUPERVISE_INTERVAL')
            if interval_s is None else interval_s)
        self._watches = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.events = []

    # -- enrollment ---------------------------------------------------------

    def watch(self, model, wedge_ms=None, start=True):
        """Supervise ``model``: a replica mid-flush with no progress
        past ``wedge_ms`` (default ``MXTPU_SERVE_WEDGE_MS``) — or a
        worker dead on an exception — is quarantined and replaced.
        ``wedge_ms`` must exceed the model's worst-case flush time: a
        healthy slow flush past it reads as wedged."""
        if wedge_ms is None:
            wedge_ms = float(config.get('MXTPU_SERVE_WEDGE_MS'))
        w = _SupWatch(model, float(wedge_ms) / 1e3)
        with self._lock:
            self._watches[model] = w
        if start:
            self.start()
        return w

    def unwatch(self, model):
        with self._lock:
            self._watches.pop(model, None)

    def watched(self):
        with self._lock:
            return sorted(self._watches)

    def state(self, model):
        """``{rid: state}`` for every live replica plus quarantined
        ones: 'healthy' | 'wedged' | 'dead' | 'quarantined' |
        'replacing'."""
        with self._lock:
            w = self._watches.get(model)
            states = dict(w.states) if w is not None else {}
        entry = self._server._models.get(model)
        if entry is not None:
            for rep in list(entry.replicas):
                states.setdefault(rep.rid, 'healthy')
        return states

    def protected(self, model):
        """Replica ids ``scale_down`` must not remove: replacements
        still inside their post-repair grace window."""
        with self._lock:
            w = self._watches.get(model)
            if w is None:
                return set()
            self._prune(w)
            return set(w.protected)

    def _prune(self, w):
        # caller holds _lock: expire grace windows — a replacement
        # that survived its grace is just a healthy replica again
        now = time.monotonic()
        for rid in [r for r, t in w.protected.items() if now >= t]:
            del w.protected[rid]
            if w.states.get(rid) == 'replacing':
                del w.states[rid]

    # -- poll thread --------------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is not None or self.interval_s <= 0:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name='mxtpu-torch-serve-supervisor',
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
            except Exception:      # noqa: BLE001 - supervisor survives
                _log.exception('mxtpu supervisor tick failed')

    # -- the repair loop ----------------------------------------------------

    def tick(self):
        """One supervision pass over every watched model; returns the
        list of events emitted."""
        with self._lock:
            watches = list(self._watches.values())
        out = []
        for w in watches:
            try:
                out.extend(self._tick_model(w))
            except Exception:     # noqa: BLE001 - logged, next model
                _log.exception('mxtpu supervisor: tick for %r '
                                  'failed', w.model)
        return out

    def _tick_model(self, w):
        entry = self._server._models.get(w.model)
        if entry is None or entry.closed:
            self.unwatch(w.model)
            return [self._event(w, 'unwatch', None, 'model unloaded')]
        batcher = entry.batcher
        if batcher is None:
            return []
        with self._lock:
            self._prune(w)
        out = []
        suspects = []
        for rid, age in batcher.inflight_ages():
            if age >= w.wedge_s:
                suspects.append((rid, 'wedged',
                                 'no flush progress for %.0f ms '
                                 '(wedge threshold %.0f ms)'
                                 % (age * 1e3, w.wedge_s * 1e3), None))
        for rid, exc in batcher.dead_workers().items():
            suspects.append((rid, 'dead',
                             'worker died: %s' % (exc,), exc))
        for rid, why, reason, exc in suspects:
            with self._lock:
                st = w.states.get(rid)
            if st == 'quarantined':
                # already handled; 'replacing' does NOT shield — a
                # replacement that wedges or dies inside its own grace
                # window is quarantined like any other replica
                continue
            ev = self._quarantine(w, entry, rid, why, reason)
            if ev:
                out.extend(ev)
        return out

    def _quarantine(self, w, entry, rid, why, reason):
        """Quarantine + replace one replica (see the module docstring
        for the order).  Holds the model's ADMIN lock end to end: the
        autoscaler's next decision — and any reload/unload — waits for
        the repair, so a replacement's warm-up can never race a scale
        decision."""
        server = self._server
        t0 = time.monotonic()
        out = []
        with entry.admin_lock:
            if entry.closed or entry.batcher is None:
                return out
            batcher = entry.batcher
            # re-check under the lock: the flush may have completed (a
            # slow-but-healthy replica) or the obituary been handled
            # between detection and here
            if why == 'wedged':
                ages = dict(batcher.inflight_ages())
                if ages.get(rid, 0.0) < w.wedge_s:
                    out.append(self._event(
                        w, 'recovered', rid,
                        'flush completed before quarantine'))
                    return out
            elif rid not in batcher.dead_workers():
                return out
            with self._lock:
                w.states[rid] = why
                # a replacement dying inside its own grace window
                # loses the grace — a corpse must not block scale_down
                w.protected.pop(rid, None)
            # 1. seize the in-flight batch + drop the replica from the
            # registry and the metrics plane: the autoscaler's windowed
            # p99 label-merges live series only — a quarantined
            # replica's latency must stop poisoning SLO decisions
            seized = batcher.seize_inflight(rid)
            entry.replicas[:] = [r for r in entry.replicas
                                 if r.rid != rid]
            instrument.drop_labeled_metrics(model=w.model,
                                            replica=str(rid))
            instrument.inc('serving.quarantines')
            instrument.inc('serving.quarantines|model=%s' % w.model)
            with self._lock:
                w.states[rid] = 'quarantined'
            out.append(self._event(
                w, 'quarantine', rid, reason, why=why,
                inflight=len(seized or ())))
            # 2. replay the seized requests at the head of their lane —
            # exactly once each; a second quarantine fails them typed
            if seized:
                replayed, failed = batcher.requeue_head(
                    seized, ReplicaQuarantinedError(
                        'model %r replica %r quarantined (%s) and the '
                        'request already replayed once'
                        % (w.model, rid, why)))
                if replayed or failed:
                    out.append(self._event(
                        w, 'replay', rid,
                        '%d in-flight request(s) re-queued at lane '
                        'head, %d failed typed' % (replayed, failed),
                        replayed=replayed, failed=failed))
            # 3. replacement BEFORE tear-down: capacity first.  The
            # quarantined slot is still busy (its worker/zombie holds
            # it), so scale_up lands on another slot; when it refuses
            # (e.g. a dead worker held the LAST free slot of a sharded
            # mesh), detach first to free the slot and retry once.
            n = self._replace(w, entry, rid)
            if n is None:
                batcher.detach_worker(rid)
                n = self._replace(w, entry, rid)
            else:
                batcher.detach_worker(rid)
            if n is not None:
                new_rid = entry.replicas[-1].rid if entry.replicas \
                    else None
                recovery = time.monotonic() - t0
                instrument.set_gauge(
                    'serving.replica_recovery_secs|model=%s' % w.model,
                    recovery)
                with self._lock:
                    if new_rid is not None:
                        w.states[new_rid] = 'replacing'
                        w.protected[new_rid] = time.monotonic() + \
                            max(w.wedge_s, 1.0)
                out.append(self._event(
                    w, 'replace', rid,
                    'replacement replica %s warmed and attached in '
                    '%.3f s' % (new_rid, recovery),
                    replacement=new_rid, recovery_s=recovery,
                    replicas=n))
            else:
                out.append(self._event(
                    w, 'replace_failed', rid,
                    'scale_up refused (no free device slot or model '
                    'closing); capacity stays reduced',
                    replicas=len(entry.replicas)))
            server._note_replicas(entry)
        return out

    def _replace(self, w, entry, rid):
        """One scale_up attempt for the quarantined ``rid`` (admin lock
        held — RLock re-entrancy lets the supervisor ride the same
        machinery the autoscaler uses).  Returns the new replica count
        or None on refusal; a genuine build failure is logged and
        reported as a refusal."""
        try:
            return self._server.scale_up(w.model)
        except Exception as e:    # noqa: BLE001 - logged verbatim
            self._event(w, 'replace_error', rid,
                        'replacement build failed: %s' % e)
            return None

    # -- event logging ------------------------------------------------------

    def _event(self, w, action, replica, reason, **extra):
        ev = {'t': time.time(), 'model': w.model, 'action': action,
              'replica': replica, 'reason': reason}
        ev.update(extra)
        self.events.append(ev)
        del self.events[:-EVENTS_CAP]
        with self._lock:
            state = dict(w.states)
        # servewatch keeps its own ring, so a replayed request's
        # postmortem can name the quarantine that displaced it
        servewatch.note_supervision(ev, state)
        # the unified decision timeline: quarantine/replace/replay all
        # land as typed decision events the chronicle journals
        instrument.decision('supervisor', action, reason=reason,
                            model=w.model, replica=replica)
        instrument.inc('serving.supervise.events')
        instrument.inc('serving.supervise.%s' % action)
        _log.info('supervise %s: %s replica=%s — %s',
                  w.model, action, replica, reason)
        return ev
