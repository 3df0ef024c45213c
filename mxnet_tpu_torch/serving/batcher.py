"""Dynamic request batching — the port of
``mxnet_tpu/serving/batcher.py``'s core loop, for one replica.

A :class:`DynamicBatcher` owns one model's admission queue and one
coalescing worker thread.  Clients enqueue single requests (dicts of
``name -> np.ndarray`` with R rows each) and get a
``concurrent.futures.Future``; the worker coalesces queued requests
front-to-back up to ``max_batch`` rows (the Predictor then pads the
merged batch to its pow2 bucket) and flushes when the cap is reached
(``serving.full_flushes``) or when the oldest queued request has waited
``max_delay_ms`` (``serving.deadline_flushes``).  Outputs are sliced
back row for row onto the per-request futures.

Admission control is the queue bound ``max_queue``: past it
:meth:`submit` sheds with :class:`ServerOverloadedError`
(``serving.shed_total``) instead of queueing without bound.

Priority lanes, request deadlines, multi-replica work stealing and the
supervision hooks of the JAX batcher wait for a later slice.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import config, instrument
from ..base import MXNetError

__all__ = ['DynamicBatcher', 'ServerOverloadedError']

_log = logging.getLogger('mxnet_tpu_torch.serving')


class ServerOverloadedError(MXNetError):
    """The admission bound rejected a request (the model's queue holds
    ``max_queue`` requests), or the model stopped with it still queued.
    Clients should back off and retry."""


class _Request(object):
    __slots__ = ('inputs', 'rows', 'future', 't_enqueue')

    def __init__(self, inputs, rows):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_enqueue = time.monotonic()


class DynamicBatcher(object):
    """One model's request queue plus its coalescing worker.

    ``execute(merged_inputs, rows) -> [out0, out1, ...]`` runs a merged
    batch of ``rows`` real rows and returns one array per model output,
    each sliced to ``rows``.  It is only ever called from the worker
    thread.  ``batch_inputs`` names the inputs that carry the batch axis
    (None: all of them); the others are per-model constants passed
    through from the first request, and a request whose constants differ
    starts its own flush.
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
        self.max_queue = int(config.get('MXTPU_SERVE_MAX_QUEUE')
                             if max_queue is None else max_queue)
        self._queue = collections.deque()
        self._cond = threading.Condition(threading.Lock())
        self._running = True
        self.last_flush_rows = 0
        self._worker = threading.Thread(
            target=self._run, args=(execute,),
            name='mxtpu-torch-serve-%s' % name, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, inputs):
        """Enqueue one request; returns its Future.  Sheds with
        :class:`ServerOverloadedError` when the queue is full."""
        inputs = {k: np.asarray(v) for k, v in inputs.items()}
        batched = inputs if self.batch_inputs is None else \
            {k: v for k, v in inputs.items() if k in self.batch_inputs}
        rows = {v.shape[0] for v in batched.values() if v.ndim > 0}
        if len(rows) != 1:
            raise MXNetError('request needs one row count across its '
                             'batch-axis inputs, got %s' % sorted(rows))
        req = _Request(inputs, rows.pop())
        with self._cond:
            if not self._running:
                raise MXNetError('model %r is unloaded' % self.name)
            if len(self._queue) >= self.max_queue:
                instrument.inc('serving.shed_total')
                raise ServerOverloadedError(
                    'model %r queue full (%d requests); shedding'
                    % (self.name, len(self._queue)))
            self._queue.append(req)
            instrument.inc('serving.requests')
            instrument.set_gauge('serving.queue_depth', len(self._queue))
            self._cond.notify_all()
        return req.future

    def depth(self):
        """Queued requests (an introspection number, read unlocked)."""
        return len(self._queue)

    def stop(self, drain=True, timeout=None):
        """Stop the worker.  ``drain=True`` serves what is queued first;
        ``drain=False`` fails it.  Past ``timeout`` (default
        ``MXTPU_SERVE_DRAIN_TIMEOUT``) whatever is still queued fails
        with :class:`ServerOverloadedError` — a bounded stop."""
        if timeout is None:
            timeout = float(config.get('MXTPU_SERVE_DRAIN_TIMEOUT'))
        with self._cond:
            self._running = False
            if not drain:
                self._fail_queued(MXNetError(
                    'model %r unloaded before execution' % self.name))
            self._cond.notify_all()
        self._worker.join(timeout=max(0.0, float(timeout)))
        with self._cond:
            self._fail_queued(ServerOverloadedError(
                'model %r stopped with requests queued; shedding'
                % self.name))
        return not self._worker.is_alive()

    def _fail_queued(self, exc):
        # caller holds the lock
        while self._queue:
            req = self._queue.popleft()
            if not req.future.cancelled():
                req.future.set_exception(exc)

    # -- worker side --------------------------------------------------------

    def _take_batch(self):
        """Wait for work, coalesce and pop one batch; None when the
        worker should exit.  Full at ``max_batch`` rows, else flushed
        when the OLDEST request has aged ``max_delay``."""
        q = self._queue
        with self._cond:
            while True:
                if q:
                    rows = sum(r.rows for r in q)
                    if rows >= self.max_batch:
                        instrument.inc('serving.full_flushes')
                    elif self._running:
                        wait = q[0].t_enqueue + self.max_delay - \
                            time.monotonic()
                        if wait > 0:
                            self._cond.wait(timeout=wait)
                            continue
                        instrument.inc('serving.deadline_flushes')
                    # else draining: flush the remainder now
                    batch, rows = [], 0
                    while q:
                        # never split a request; one above the cap still
                        # runs, alone
                        if batch and (rows + q[0].rows > self.max_batch or
                                      not self._constants_match(batch[0],
                                                                q[0])):
                            break
                        req = q.popleft()
                        batch.append(req)
                        rows += req.rows
                    instrument.set_gauge('serving.queue_depth', len(q))
                    return batch
                if not self._running:
                    return None
                self._cond.wait()

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

    def _run(self, execute):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._flush(batch, execute)

    def _flush(self, batch, execute):
        t_start = time.monotonic()
        for req in batch:
            instrument.observe_hist('serving.queue_wait_secs',
                                    t_start - req.t_enqueue)
        rows = sum(r.rows for r in batch)
        self.last_flush_rows = rows
        instrument.inc('serving.flushes')
        instrument.inc('serving.batched_requests', len(batch))
        try:
            merged = {
                k: (batch[0].inputs[k]
                    if len(batch) == 1 or (self.batch_inputs is not None
                                           and k not in self.batch_inputs)
                    else np.concatenate([r.inputs[k] for r in batch]))
                for k in batch[0].inputs}
            outs = execute(merged, rows)
        except Exception as e:             # noqa: BLE001 - fail the batch
            _log.warning('serving: model %r flush of %d rows failed: %s',
                         self.name, rows, e)
            instrument.inc('serving.errors', len(batch))
            for req in batch:
                if not req.future.cancelled():
                    req.future.set_exception(e)
            return
        t_done = time.monotonic()
        instrument.observe_hist('serving.execute_secs', t_done - t_start)
        off = 0
        for req in batch:
            # slice only outputs that carry the batch axis
            sliced = [o[off:off + req.rows]
                      if getattr(o, 'ndim', 0) and o.shape[0] == rows
                      else o for o in outs]
            off += req.rows
            instrument.observe_hist('serving.e2e_secs',
                                    t_done - req.t_enqueue)
            if not req.future.cancelled():
                req.future.set_result(sliced)
