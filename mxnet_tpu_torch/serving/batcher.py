"""Continuous/dynamic request batching — the port of
``mxnet_tpu/serving/batcher.py``.

A :class:`DynamicBatcher` owns one model's SHARED admission queue and
one coalescing worker per replica.  Clients enqueue single requests
(dicts of ``name -> np.ndarray`` with R rows each) and get a
``concurrent.futures.Future`` back; whichever replica worker is free
coalesces queued requests front-to-back up to ``max_batch`` rows (the
Predictor then pads the merged batch to its pow2 bucket, whose CUDA
graph is already captured) and flushes when the cap is reached
(``serving.full_flushes``) or when the oldest queued request has waited
``max_delay_ms`` (``serving.deadline_flushes``).  Outputs are sliced
back row for row onto the per-request futures.

**Replicas.** N workers (one per replica, each with its own execute
hook over its own Predictor) pull from the one queue, so a free replica
always takes the next flush.  Workers attach and detach at flush
boundaries (:meth:`add_worker` / :meth:`remove_worker` /
:meth:`detach_worker`); removing the LAST worker fails what is queued
with :class:`ServerOverloadedError` instead of hanging the futures.

**Priority lanes.** ``interactive`` requests ride an express lane that
an idle worker always takes first: interactive traffic preempts batch
coalescing at flush boundaries (``serving.preempt_flushes``), and a
rate-limited starvation valve serves one batch flush ahead of it once a
batch request has waited ``starve_after`` (``serving.starvation_flushes``).
Lanes never share a flush, and each lane has its own admission bound
(``max_queue``): past it :meth:`submit` sheds with
:class:`ServerOverloadedError`.

**Deadlines.** A request carries a drop-dead instant
(``submit(deadline_ms=)``, default ``MXTPU_SERVE_DEADLINE_MS``); past it
the request is dropped at coalesce time, never executed, and fails with
:class:`DeadlineExceededError` (``serving.deadline_drops``, kept out of
the latency histograms).

**Supervision signals.** Each worker registers its in-flight flush
(:meth:`inflight_ages`, the no-progress signal) and its death outside a
flush (:meth:`dead_workers`); the supervisor seizes a wedged flush
(:meth:`seize_inflight`) and replays it once at its lane's head
(:meth:`requeue_head`); a second displacement fails typed
(:class:`ReplicaQuarantinedError`).  The fault sites ``serve.worker.r<id>``
and ``serve.flush.r<id>`` are kept (``resilience.fault_point``).

**Brownout.** With :attr:`shed_batch` set (the autoscaler's first
brownout rung) the batch lane sheds at admission
(``serving.brownout_sheds``) while the interactive lane keeps serving;
:attr:`max_batch` may be shrunk below :attr:`configured_max_batch`, the
cap replicas warm to.

Every stage lands in the instrument registry: ``serving.queue_wait_secs``
/ ``serving.execute_secs`` / ``serving.e2e_secs`` histograms (the e2e
ones with request-id exemplars under servewatch), both the model-wide
series and labeled per-replica / per-lane ones
(``serving.e2e_secs|lane=interactive,model=m,replica=0``), the
``serving.requests`` / ``batched_requests`` / ``flushes`` counters and,
under profiling, a ``serving.flush[<model>]`` span around each execute.
With servewatch on, each request is stamped at admission and finished
against its flush's composition record (:mod:`.servewatch`).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import config, instrument, resilience
from ..base import MXNetError
from . import servewatch

__all__ = ['DynamicBatcher', 'ServerOverloadedError',
           'DeadlineExceededError', 'ReplicaQuarantinedError',
           'LANE_BATCH', 'LANE_INTERACTIVE']

LANE_BATCH = 'batch'
LANE_INTERACTIVE = 'interactive'

_log = logging.getLogger('mxnet_tpu_torch.serving')


class ServerOverloadedError(MXNetError):
    """A lane's admission bound rejected the request (it holds
    ``max_queue`` requests), or the model lost its last replica or
    stopped with the request still queued.  Clients should back off and
    retry."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed while it was still queued: it was
    dropped at coalesce time, never executed (``serving.deadline_drops``;
    not in the latency histograms)."""


class ReplicaQuarantinedError(MXNetError):
    """The replica serving (or draining) this request was quarantined
    (wedged or dead) and the request could not be replayed: it had
    already replayed once, or a bounded drain ended with it in flight."""


class _Request(object):
    # t_submit/t_admit/admit_depths are stamped by servewatch.admit when
    # the plane is on; req_id is always set (None: not traced)
    __slots__ = ('inputs', 'rows', 'future', 't_enqueue', 'lane',
                 'req_id', 't_submit', 't_admit', 'admit_depths',
                 'deadline', 'replayed')

    def __init__(self, inputs, rows, lane):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_enqueue = time.monotonic()
        self.lane = lane
        self.req_id = None
        self.deadline = None      # monotonic drop-dead instant, or None
        self.replayed = False     # re-queued once by a quarantine


class DynamicBatcher(object):
    """One model's shared request queue plus per-replica coalescing
    workers.

    ``execute(merged_inputs, rows) -> [out0, out1, ...]`` is replica 0's
    model hook (more replicas attach with :meth:`add_worker`): it runs
    the merged batch of ``rows`` real rows and returns one array per
    output, each sliced to ``rows``.  Each hook is only ever called from
    its own worker thread.  ``batch_inputs`` names the inputs that carry
    the batch axis (None: all of them); the others are per-model
    constants passed through from the first request, and a request whose
    constants differ starts its own flush.
    """

    def __init__(self, name, execute, max_delay_ms=None, max_batch=None,
                 max_queue=None, batch_inputs=None):
        self.name = name
        self.batch_inputs = None if batch_inputs is None \
            else set(batch_inputs)
        self.max_delay = (config.get('MXTPU_SERVE_MAX_DELAY_MS')
                          if max_delay_ms is None else max_delay_ms) / 1e3
        self.max_batch = int(config.get('MXTPU_SERVE_MAX_BATCH')
                             if max_batch is None else max_batch)
        # the CONFIGURED cap: the autoscaler shrinks and restores
        # max_batch, but warm-ups and the restore target speak this
        self.configured_max_batch = self.max_batch
        self.max_queue = int(config.get('MXTPU_SERVE_MAX_QUEUE')
                             if max_queue is None else max_queue)
        # the starvation valve: past this wait one batch flush goes ahead
        # of the interactive lane (rate-limited, see _pick_lane)
        self.starve_after = max(50.0 * self.max_delay, 1.0)
        self._last_starve = 0.0
        # _queue is the batch lane, _hi the interactive express lane
        self._queue = collections.deque()
        self._hi = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = True
        self._held = False            # pause(): queue but do not flush
        self.last_flush_rows = 0
        self.last_flush_replica = None
        self._workers = {}            # replica id -> Thread
        self._retired = set()         # replica ids told to exit
        self._zombies = {}            # rid -> thread whose join timed out
        # the supervision signals: rid -> (batch, t_start, token) while a
        # flush is in flight; rid -> the exception its worker died of
        self._inflight = {}
        self._dead = {}
        # brownout level 1: the batch lane sheds at admission
        self.shed_batch = False
        self.default_deadline_ms = float(
            config.get('MXTPU_SERVE_DEADLINE_MS'))
        # labeled metric names, built once so a flush builds no strings
        self._lane_e2e = {}
        self._lane_qwait = {
            lane: 'serving.queue_wait_secs|lane=%s,model=%s' % (lane, name)
            for lane in (LANE_BATCH, LANE_INTERACTIVE)}
        self._rep_exec = {}
        self._rep_flush = {}
        self._start_worker(0, execute)

    # -- client side --------------------------------------------------------

    def submit(self, inputs, priority=None, deadline_ms=None):
        """Enqueue one request (``{name: array}``; batch-axis inputs share
        one leading row count, constant inputs ride along whole); returns
        its Future.  ``priority`` is ``'interactive'`` or
        ``'batch'``/None.  ``deadline_ms`` (None: the default; 0: none)
        bounds the wait in the queue.  Sheds with
        :class:`ServerOverloadedError` when the lane is full, or (the
        batch lane) while :attr:`shed_batch` is set."""
        sw = servewatch.enabled()
        t_submit = time.monotonic() if sw else 0.0
        if priority in (None, LANE_BATCH):
            lane, q = LANE_BATCH, self._queue
        elif priority == LANE_INTERACTIVE:
            lane, q = LANE_INTERACTIVE, self._hi
        else:
            raise MXNetError("priority must be 'interactive' or "
                             "'batch', got %r" % (priority,))
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        inputs = {k: np.asarray(v) for k, v in inputs.items()}
        batched = inputs if self.batch_inputs is None else \
            {k: v for k, v in inputs.items() if k in self.batch_inputs}
        rows = {v.shape[0] for v in batched.values() if v.ndim > 0}
        if len(rows) != 1:
            raise MXNetError('request needs one row count across its '
                             'batch-axis inputs, got %s' % sorted(rows))
        req = _Request(inputs, rows.pop(), lane)
        if deadline_ms and deadline_ms > 0:
            req.deadline = req.t_enqueue + deadline_ms / 1e3
        with self._cond:
            if not self._running:
                raise MXNetError('model %r is unloaded' % self.name)
            if lane == LANE_BATCH and self.shed_batch:
                # POLICY sheds stay out of the per-lane shed_total series
                # the autoscaler reads as breach evidence, or sustained
                # batch load would hold the breach up and the ladder
                # could never come down
                instrument.inc('serving.shed_total')
                instrument.inc('serving.brownout_sheds')
                instrument.inc('serving.brownout_sheds|model=%s'
                               % self.name)
                if sw:
                    servewatch.note_shed(self.name, lane, len(q),
                                         self.depth())
                raise ServerOverloadedError(
                    'model %r batch lane browned out; shedding'
                    % self.name)
            if len(q) >= self.max_queue:
                instrument.inc('serving.shed_total')
                instrument.inc('serving.shed_total|model=%s,lane=%s'
                               % (self.name, lane))
                if sw:
                    servewatch.note_shed(self.name, lane, len(q),
                                         self.depth())
                raise ServerOverloadedError(
                    'model %r %s lane full (%d requests); shedding'
                    % (self.name, lane, len(q)))
            q.append(req)
            if sw:
                req.t_submit = t_submit
                servewatch.admit(req, self.name, len(q), self.depth())
            instrument.inc('serving.requests')
            instrument.set_gauge('serving.queue_depth', self.depth())
            self._cond.notify_all()
        return req.future

    def depth(self):
        """Queued requests across both lanes (read unlocked: an
        introspection number)."""
        return len(self._queue) + len(self._hi)

    def queued_rows(self):
        """Queued ROWS across both lanes, the unit ``max_batch`` speaks
        (the autoscaler's backlog signal)."""
        with self._lock:
            return sum(r.rows for r in self._queue) + \
                sum(r.rows for r in self._hi)

    def pause(self):
        """Hold flushing; requests keep queueing under admission
        control."""
        with self._cond:
            self._held = True

    def resume(self):
        with self._cond:
            self._held = False
            self._cond.notify_all()

    # -- replica lifecycle --------------------------------------------------

    def add_worker(self, replica, execute):
        """Attach one more worker (a new replica) to the shared queue."""
        with self._cond:
            if not self._running:
                raise MXNetError('model %r is unloaded' % self.name)
            if replica in self._workers:
                raise MXNetError('replica %r already attached' % replica)
            z = self._zombies.get(replica)
            if z is not None:
                if z.is_alive():
                    # a timed-out removal's worker still drains on this
                    # id: un-retiring it would resurrect it next to the
                    # new worker, serving through a removed hook
                    raise MXNetError(
                        'replica id %r still has a draining worker '
                        'from a timed-out removal; retry later or '
                        'use another slot' % replica)
                del self._zombies[replica]
            self._retired.discard(replica)
        self._start_worker(replica, execute)

    def _start_worker(self, replica, execute):
        t = threading.Thread(
            target=self._run, args=(replica, execute),
            name='mxtpu-torch-serve-%s-r%s' % (self.name, replica),
            daemon=True)
        with self._cond:
            self._workers[replica] = t
        t.start()

    def remove_worker(self, replica, timeout=60):
        """Detach one worker gracefully: it finishes its in-flight flush
        (retirement is checked at flush boundaries), then exits.  A
        worker still wedged when the join's ``timeout`` passes becomes a
        zombie and its in-flight requests fail with
        :class:`ReplicaQuarantinedError`.  Removing the LAST worker fails
        what is queued with :class:`ServerOverloadedError`."""
        with self._cond:
            t = self._workers.get(replica)
            if t is None:
                return False
            self._retired.add(replica)
            self._cond.notify_all()
        t.join(timeout=timeout)
        if t.is_alive():
            seized = self.seize_inflight(replica)
            if seized:
                err = ReplicaQuarantinedError(
                    'model %r replica %r wedged during removal; its '
                    'in-flight requests fail rather than hang'
                    % (self.name, replica))
                for req in seized:
                    if not req.future.done():
                        req.future.set_exception(err)
        with self._cond:
            self._workers.pop(replica, None)
            self._dead.pop(replica, None)
            if t.is_alive():
                self._zombies[replica] = t
            if not self._workers:
                self._running = False
                self._fail_queued(ServerOverloadedError(
                    'model %r lost its last replica with requests '
                    'queued; shedding' % self.name))
        return True

    def detach_worker(self, replica, keep_running=False):
        """Quarantine detach: retire ``replica``'s worker WITHOUT joining
        it (it may be wedged inside a flush).  A live thread is kept as a
        zombie so :meth:`add_worker` cannot reuse its id under it; if it
        wakes, it abandons its seized flush and exits.  If this was the
        last worker, what is queued sheds typed, unless ``keep_running``
        (a replacement is about to attach: the queue waits for it, and
        the caller calls :meth:`shed_if_workerless` if none came)."""
        with self._cond:
            t = self._workers.pop(replica, None)
            self._retired.add(replica)
            self._dead.pop(replica, None)
            if t is not None and t.is_alive():
                self._zombies[replica] = t
            if not keep_running:
                self._shed_if_workerless()
            self._cond.notify_all()
        return t is not None

    def shed_if_workerless(self):
        """With no worker left, stop admitting and fail what is queued
        typed (the last-replica rule of :meth:`detach_worker`)."""
        with self._cond:
            self._shed_if_workerless()
            self._cond.notify_all()

    def _shed_if_workerless(self):
        if not self._workers:
            self._running = False
            self._fail_queued(ServerOverloadedError(
                'model %r lost its last replica with requests '
                'queued; shedding' % self.name))

    def requeue_head(self, batch, error):
        """Re-queue a quarantined replica's seized requests at the HEAD
        of their lane, once each (a forward has no side effects, so one
        replay is safe).  A request that already replayed, or any
        request once the batcher stopped admitting, fails with
        ``error``.  Returns ``(replayed, failed)``."""
        replayed = failed = 0
        with self._cond:
            for req in reversed(batch):
                if req.future.done():
                    continue
                if req.replayed or not self._running:
                    req.future.set_exception(error)
                    failed += 1
                    continue
                req.replayed = True
                q = self._hi if req.lane == LANE_INTERACTIVE \
                    else self._queue
                q.appendleft(req)
                replayed += 1
            if replayed:
                instrument.inc('serving.replays', replayed)
                instrument.inc('serving.replays|model=%s' % self.name,
                               replayed)
                self._cond.notify_all()
        return replayed, failed

    def seize_inflight(self, replica):
        """Take ``replica``'s in-flight batch (quarantine or a bounded
        drain); its worker finds the seizure at its flush boundary and
        delivers nothing.  None when nothing is in flight."""
        with self._lock:
            ent = self._inflight.pop(replica, None)
        return ent[0] if ent else None

    def inflight_ages(self):
        """``[(replica, age_seconds)]`` of flushes in flight.  An idle
        worker has no entry: idle is healthy, not wedged."""
        now = time.monotonic()
        with self._lock:
            return [(rid, now - ent[1])
                    for rid, ent in self._inflight.items()]

    def dead_workers(self):
        """``{replica: exception}`` of workers that died outside a
        flush's own error handling (an :class:`InjectedDeath` too)."""
        with self._cond:
            return dict(self._dead)

    def slot_busy(self, replica):
        """True while ``replica``'s id cannot be reused: an attached
        worker, or a zombie thread still running on it."""
        with self._cond:
            if replica in self._workers:
                return True
            z = self._zombies.get(replica)
            return z is not None and z.is_alive()

    def workers(self):
        with self._cond:
            return sorted(self._workers)

    def stop(self, drain=True, timeout=None):
        """Stop every worker.  ``drain=True`` flushes what is queued
        first; ``drain=False`` fails it with :class:`MXNetError`.  The
        whole stop shares one ``timeout`` (default
        ``MXTPU_SERVE_DRAIN_TIMEOUT``): past it, what is queued sheds
        typed and a wedged worker's in-flight requests fail with
        :class:`ReplicaQuarantinedError`.  Returns True when every worker
        exited in time."""
        if timeout is None:
            timeout = float(config.get('MXTPU_SERVE_DRAIN_TIMEOUT'))
        t_end = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            self._running = False
            self._held = False
            if not drain:
                self._fail_queued(MXNetError(
                    'model %r unloaded before execution' % self.name))
            self._cond.notify_all()
            workers = list(self._workers.items())
        for rid, t in workers:
            t.join(timeout=max(0.0, t_end - time.monotonic()))
        wedged = [rid for rid, t in workers if t.is_alive()]
        with self._cond:
            self._workers.clear()
            for rid, t in workers:
                if t.is_alive():
                    self._retired.add(rid)
                    self._zombies[rid] = t
            self._fail_queued(ServerOverloadedError(
                'model %r stopped with requests queued; shedding'
                % self.name))
        for rid in wedged:
            seized = self.seize_inflight(rid)
            if not seized:
                continue
            err = ReplicaQuarantinedError(
                'model %r replica %r still wedged at the drain '
                'deadline; its in-flight requests fail rather than '
                'hang' % (self.name, rid))
            for req in seized:
                if not req.future.done():
                    req.future.set_exception(err)
        return not wedged

    def _fail_queued(self, exc):
        # caller holds the lock
        for q in (self._hi, self._queue):
            while q:
                req = q.popleft()
                if not req.future.cancelled():
                    req.future.set_exception(exc)

    # -- worker side --------------------------------------------------------

    def _pick_lane(self):
        """The lane the next flush takes (caller holds the lock):
        interactive first, unless the batch lane's oldest request has
        starved past ``starve_after`` — and then at most one batch flush
        per ``starve_after``, or a deep old backlog would invert the
        priority."""
        if self._hi:
            now = time.monotonic()
            if self._queue and \
                    now - self._queue[0].t_enqueue > self.starve_after \
                    and now - self._last_starve > self.starve_after:
                self._last_starve = now
                return self._queue
            return self._hi
        if self._queue:
            return self._queue
        return None

    def _take_batch(self, replica):
        """Wait for work, coalesce and pop one batch; None when this
        worker should exit.  Per lane: full at ``max_batch`` rows, else
        flushed when the lane's OLDEST request has aged ``max_delay``."""
        with self._cond:
            while True:
                if replica in self._retired:
                    return None
                q = None if self._held else self._pick_lane()
                if q is not None:
                    # an expired head never reaches the model: drop it
                    # and pick again
                    if q[0].deadline is not None and \
                            self._purge_expired(q):
                        continue
                    rows = sum(r.rows for r in q)
                    if rows >= self.max_batch:
                        instrument.inc('serving.full_flushes')
                    elif not self._running:
                        pass       # draining: flush the remainder now
                    else:
                        wait = q[0].t_enqueue + self.max_delay - \
                            time.monotonic()
                        if wait > 0:
                            self._cond.wait(timeout=wait)
                            continue
                        instrument.inc('serving.deadline_flushes')
                elif not self._running:
                    return None
                else:
                    self._cond.wait()
                    continue
                if q is self._hi and self._queue:
                    instrument.inc('serving.preempt_flushes')
                elif q is self._queue and self._hi:
                    instrument.inc('serving.starvation_flushes')
                batch, rows = [], 0
                now = time.monotonic()
                while q:
                    # never split a request; one above the cap runs alone
                    if batch and rows + q[0].rows > self.max_batch:
                        break
                    if batch and not self._constants_match(batch[0],
                                                           q[0]):
                        break
                    req = q.popleft()
                    if req.deadline is not None and now >= req.deadline:
                        self._expire(req, now)
                        continue
                    batch.append(req)
                    rows += req.rows
                instrument.set_gauge('serving.queue_depth', self.depth())
                if not batch:
                    continue   # everything coalescible had expired
                return batch

    def _purge_expired(self, q):
        """Drop the expired run at ``q``'s head (caller holds the lock);
        returns how many went."""
        now = time.monotonic()
        n = 0
        while q and q[0].deadline is not None and now >= q[0].deadline:
            self._expire(q.popleft(), now)
            n += 1
        return n

    def _expire(self, req, now):
        """Fail one expired request typed (caller holds the lock); it is
        counted and kept out of the latency histograms."""
        instrument.inc('serving.deadline_drops')
        instrument.inc('serving.deadline_drops|model=%s,lane=%s'
                       % (self.name, req.lane))
        if servewatch.enabled() and req.req_id is not None:
            servewatch.note_deadline(self.name, req, now)
        if not req.future.cancelled():
            req.future.set_exception(DeadlineExceededError(
                'model %r request waited %.1f ms, past its %.1f ms '
                'deadline; dropped at coalesce time'
                % (self.name, (now - req.t_enqueue) * 1e3,
                   (req.deadline - req.t_enqueue) * 1e3)))

    def _constants_match(self, a, b):
        if self.batch_inputs is None:
            return True
        for k, va in a.inputs.items():
            if k in self.batch_inputs:
                continue
            vb = b.inputs.get(k)
            if vb is None or va.shape != vb.shape or \
                    not np.array_equal(va, vb):
                return False
        return True

    def _run(self, replica, execute):
        exec_name = self._rep_exec.setdefault(
            replica, 'serving.execute_secs|model=%s,replica=%s'
            % (self.name, replica))
        flush_name = self._rep_flush.setdefault(
            replica, 'serving.flushes|model=%s,replica=%s'
            % (self.name, replica))
        site_op = 'r%s' % replica
        try:
            while True:
                if resilience.faults_on():
                    # 'serve.worker.r<id>': a 'kill' here kills THIS
                    # worker (InjectedDeath), not the process
                    resilience.fault_point('serve.worker', op=site_op,
                                           thread_kill=True)
                batch = self._take_batch(replica)
                if batch is None:
                    return
                token = self._begin_flush(replica, batch)
                self._flush(batch, replica, execute, exec_name,
                            flush_name, token)
        except BaseException as e:    # noqa: BLE001 - the worker's obituary
            # recorded so the supervisor can replace the replica: a dead
            # worker must shrink capacity visibly
            with self._cond:
                self._dead[replica] = e
            _log.warning('serving: model %r replica %r worker died: %s',
                         self.name, replica, e)

    def _begin_flush(self, replica, batch):
        """Register ``batch`` as ``replica``'s in-flight flush; returns
        the ownership token :meth:`_finish_flush` checks."""
        token = object()
        with self._lock:
            self._inflight[replica] = (batch, time.monotonic(), token)
        return token

    def _finish_flush(self, replica, token):
        """Clear the in-flight entry if this worker still owns it; False
        means the flush was seized and its requests live elsewhere."""
        with self._lock:
            ent = self._inflight.get(replica)
            if ent is not None and ent[2] is token:
                del self._inflight[replica]
                return True
        return False

    def _flush(self, batch, replica, execute, exec_name, flush_name,
               token=None):
        # t_start is the chain's "taken" boundary: the batch was popped
        # just before this call
        t_start = time.monotonic()
        sw = servewatch.enabled() and batch[0].req_id is not None
        lane = batch[0].lane
        qwait_name = self._lane_qwait[lane]
        for req in batch:
            wait = t_start - req.t_enqueue
            instrument.observe_hist('serving.queue_wait_secs', wait)
            instrument.observe_hist(qwait_name, wait)
        rows = sum(r.rows for r in batch)
        self.last_flush_rows = rows
        self.last_flush_replica = replica
        instrument.inc('serving.flushes')
        instrument.inc(flush_name)
        instrument.inc('serving.batched_requests', len(batch))
        t_exec0 = 0.0
        try:
            if resilience.faults_on():
                # 'serve.flush.r<id>': a 'wedge' holds the flush in
                # flight without progress (the quarantine drill)
                resilience.fault_point('serve.flush', op='r%s' % replica)
            merged = {
                k: (batch[0].inputs[k]
                    if len(batch) == 1 or (self.batch_inputs is not None
                                           and k not in self.batch_inputs)
                    else np.concatenate([r.inputs[k] for r in batch]))
                for k in batch[0].inputs}
            if sw:
                t_exec0 = time.monotonic()   # host merge done
            with instrument.span('serving.flush[%s]' % self.name,
                                 cat='serving',
                                 args={'rows': rows,
                                       'requests': len(batch),
                                       'model': self.name,
                                       'replica': replica,
                                       'lane': lane}):
                # on the card execute() returns after the host copy-out,
                # which waits on the replica's stream: t_exec1 closes the
                # device time
                outs = execute(merged, rows)
            t_exec1 = time.monotonic()
            dt = t_exec1 - t_start
            instrument.observe_hist('serving.execute_secs', dt)
            instrument.observe_hist(exec_name, dt)
        except Exception as e:            # noqa: BLE001 - fail the batch
            if token is not None and \
                    not self._finish_flush(replica, token):
                # seized mid-execute: replayed or failed elsewhere
                instrument.inc('serving.abandoned_flushes')
                return
            _log.warning('serving: model %r flush of %d rows on replica '
                         '%r failed: %s', self.name, rows, replica, e)
            instrument.inc('serving.errors', len(batch))
            if sw:
                servewatch.note_error(self.name, lane, replica, batch,
                                      self.max_delay, t_start,
                                      t_exec0 or t_start, e)
            for req in batch:
                if not req.future.cancelled():
                    req.future.set_exception(e)
            return
        if token is not None and not self._finish_flush(replica, token):
            # seized mid-execute: delivering would resolve twice
            instrument.inc('serving.abandoned_flushes')
            return
        t_done = time.monotonic()
        frec = servewatch.open_flush(
            self.name, lane, replica, batch, rows, self.max_delay,
            t_start, t_exec0, t_exec1, execute) if sw else None
        e2e_name = self._lane_e2e.get((lane, replica))
        if e2e_name is None:
            e2e_name = self._lane_e2e[(lane, replica)] = (
                'serving.e2e_secs|lane=%s,model=%s,replica=%s'
                % (lane, self.name, replica))
        off = 0
        for req in batch:
            # slice only outputs that carry the batch axis
            sliced = [o[off:off + req.rows]
                      if getattr(o, 'ndim', 0) and o.shape[0] == rows
                      else o for o in outs]
            off += req.rows
            e2e = t_done - req.t_enqueue
            instrument.observe_hist('serving.e2e_secs', e2e,
                                    exemplar=req.req_id)
            instrument.observe_hist(e2e_name, e2e, exemplar=req.req_id)
            if frec is not None:
                servewatch.deliver(frec, req, time.monotonic())
            if not req.future.cancelled():
                req.future.set_result(sliced)
        if frec is not None:
            servewatch.close_flush(frec)
