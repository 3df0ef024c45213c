"""Input-pipeline & goodput attribution plane — per-stage iterator
accounting and the wall-clock goodput ledger; the port of
``mxnet_tpu/iowatch.py``.

1. **Per-stage pipeline attribution** — :func:`stage` wraps a link of
   the iterator chain in an ``iowatch.stage.<name>`` histogram (and a
   trace span under profiling, :func:`instrument.hist_span`):
   ``feed_wait`` / ``device_stage`` (the double-buffered feed,
   ``io.DeviceFeedIter``, with the ``iowatch.feed_ready`` occupancy
   gauge) and ``window_wait`` (the async step window's wait on the card,
   ``engine.StepWindow``: the healthy counterpart that says the DEVICE,
   not the input path, is the bottleneck).  The reference's
   ``read``/``decode``/``augment``/``batchify``/``prefetch_wait`` stages
   belong to the record readers, which come with them.  :func:`note_batch`
   adds delivered-batch throughput (``iowatch.samples_per_sec`` /
   ``iowatch.bytes_per_sec`` from one rolling window, ``iowatch.batches``
   / ``iowatch.samples`` / ``iowatch.bytes`` counters), once per
   DELIVERED batch like ``io.batches``.

2. **Goodput ledger** — :func:`activate_fit` (``BaseModule.fit``) opens a
   wall-clock ledger owned by the fit thread; :func:`account` regions
   attribute its time into EXCLUSIVE badput buckets (``input_stall``,
   ``compile``, ``metric_drain``, ``checkpoint``, ``barrier``,
   ``recovery``, ``eval``; nested regions pause their parent, and calls
   from other threads no-op).  ``health_skipped`` is apportioned at the
   end from the health monitor's skipped-step fraction, and everything
   unaccounted is the **productive step** remainder, so the buckets sum
   to the wall clock exactly and ``goodput.fraction`` = productive /
   wall.  Published as ``goodput.*`` gauges (again at every metric
   drain) and put into every flight-recorder dump
   (:func:`goodput_snapshot`).  :func:`traced_dispatch` charges a fit
   step to ``compile`` when it captured a CUDA graph (the
   ``compile.traces`` counter moved), less what nested regions already
   took: the counterpart of the reference's jit-trace detector.

Off by default: every hook is one module-global check.
``MXTPU_IOWATCH=1`` implies the metrics registry.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from . import config, instrument

__all__ = [
    'enabled', 'set_enabled', 'refresh', 'activate_fit',
    'stage', 'note_batch', 'set_depth',
    'GoodputLedger', 'BUCKETS',
    'goodput_begin', 'goodput_end', 'goodput_ledger', 'goodput_snapshot',
    'account', 'charge', 'traced_dispatch', 'note_health',
]

# Exclusive badput buckets of the goodput ledger, in triage order.
# ``health_skipped`` is derived at ledger close (skipped-step fraction
# of the productive remainder); ``productive`` is the remainder itself.
BUCKETS = ('input_stall', 'compile', 'metric_drain', 'checkpoint',
           'barrier', 'recovery', 'eval', 'health_skipped')

_on = False


# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------

def refresh():
    """(Re)read MXTPU_IOWATCH.  Called at import and per fit
    (:func:`activate_fit`); hot-path hooks read the cached module
    global only."""
    global _on
    _on = bool(config.get('MXTPU_IOWATCH'))
    if _on and not instrument.metrics_enabled():
        # the plane's output IS the metrics registry — implied on, the
        # same contract as MXTPU_PROFILE / MXTPU_PERFWATCH
        instrument.set_metrics(True)


def set_enabled(on):
    """Runtime toggle (tests; equivalent to exporting MXTPU_IOWATCH)."""
    global _on
    _on = bool(on)
    if _on and not instrument.metrics_enabled():
        instrument.set_metrics(True)


def enabled():
    return _on


def activate_fit():
    """Called by ``BaseModule.fit`` before the first batch: re-read the
    knob so an env var exported between fits takes effect, reset the
    throughput window, and open a fresh goodput ledger owned by the
    calling (fit) thread.  Returns the ledger this fit OPENED (the
    token its ``finally`` passes back to :func:`goodput_end`), or None
    when the plane is off or another fit's ledger is already live — a
    nested fit (launched from a callback) or a concurrent-thread fit
    must not clobber the outer fit's wall-clock ledger, and must not
    close it on the way out."""
    global _ledger
    refresh()
    if not _on:
        return None
    with _ledger_lock:
        # atomic check-then-open: two fits racing here must not BOTH
        # obtain tokens (the second would clobber the first's ledger)
        if _ledger is not None:
            return None
        _batch_window.clear()
        _ledger = GoodputLedger()
        return _ledger


# ---------------------------------------------------------------------------
# Leg 1: per-stage pipeline attribution
# ---------------------------------------------------------------------------

# shared no-op for every disabled context-manager hook — the single
# instance instrument exports for all planes
_NULL = instrument.NULL_CTX


def stage(name):
    """Attribute the wrapped region's wall time to pipeline stage
    ``name`` (``iowatch.stage.<name>`` histogram; a trace span too under
    profiling — :func:`instrument.hist_span`, the same clock the
    ``perf.phase.*`` spans use).  The shared no-op when the plane is
    off."""
    if not _on:
        return _NULL
    return instrument.hist_span('iowatch.stage.' + name, cat='io')


def set_depth(name, value):
    """Queue-depth/occupancy gauge helper (``iowatch.<name>``): one
    flag check when off."""
    if _on:
        instrument.set_gauge('iowatch.' + name, value)


# rolling window of (monotonic, samples, bytes) per delivered batch
_batch_window = deque(maxlen=64)


def _batch_bytes(batch):
    """Total payload bytes of one DataBatch's data and label arrays
    (tensors, NDArrays or numpy arrays; 0 for anything else)."""
    import numpy as np
    import torch
    total = 0
    for arrs in (batch.data, batch.label):
        for a in arrs or []:
            h = getattr(a, 'handle', a)
            try:
                if isinstance(h, torch.Tensor):
                    total += h.numel() * h.element_size()
                else:
                    total += int(np.asarray(h).nbytes)
            except Exception:        # noqa: BLE001
                pass
    return total


def note_batch(batch):
    """One batch DELIVERED by the iterator chain (called where
    ``io.batches`` is counted, so merging wrappers count once): advance
    the rolling throughput window and publish
    ``iowatch.samples_per_sec`` / ``iowatch.bytes_per_sec``.  One flag
    check when off."""
    if not _on:
        return
    try:
        rows = batch.data[0].shape[0] if batch.data else 0
        rows -= getattr(batch, 'pad', 0) or 0
    except Exception:
        rows = 0
    nbytes = _batch_bytes(batch)
    now = time.monotonic()
    _batch_window.append((now, rows, nbytes))
    instrument.inc('iowatch.batches')
    if rows:
        instrument.inc('iowatch.samples', int(rows))
    if nbytes:
        instrument.inc('iowatch.bytes', int(nbytes))
    if len(_batch_window) >= 2:
        dt = _batch_window[-1][0] - _batch_window[0][0]
        if dt > 0:
            # the oldest entry marks the window start; its own rows
            # were delivered before it, so sum the later entries only
            samples = sum(r for _, r, _ in list(_batch_window)[1:])
            bts = sum(b for _, _, b in list(_batch_window)[1:])
            instrument.set_gauge('iowatch.samples_per_sec', samples / dt)
            instrument.set_gauge('iowatch.bytes_per_sec', bts / dt)


# ---------------------------------------------------------------------------
# Leg 2: goodput ledger
# ---------------------------------------------------------------------------

class GoodputLedger(object):
    """One fit's wall-clock attribution.  Owned by the thread that
    created it (the fit loop): :meth:`account` regions on that thread
    charge their elapsed time to a named badput bucket — nested regions
    PAUSE their parent, so the buckets stay exclusive by construction —
    and everything unaccounted is the productive-step remainder.
    Calls from any other thread are no-ops: a producer thread's time is
    not fit-loop wall clock and must not corrupt the identity
    ``wall == productive + sum(buckets)``."""

    def __init__(self):
        self._owner = threading.get_ident()
        self._t0 = time.monotonic()
        self._end = None
        self._secs = {b: 0.0 for b in BUCKETS}
        self._events = {b: 0 for b in BUCKETS}
        self._stack = []          # open bucket names, owner thread only
        self._open_t = None       # start of the innermost open region
        self._health = None       # (steps, nan_steps) under skip_update

    def owner(self):
        return threading.get_ident() == self._owner

    # a STICKY outer region absorbs nested regions: everything inside
    # an epoch-end score() is evaluation time, even the eval iterator's
    # own input waits — charging those to input_stall would make the
    # advisor blame the training pipeline for eval cost
    _STICKY = ('eval',)

    # -- region accounting (owner thread only) -----------------------------
    def _enter(self, bucket):
        now = time.monotonic()
        if self._stack:
            self._secs[self._stack[-1]] += now - self._open_t
            if self._stack[-1] in self._STICKY:
                bucket = self._stack[-1]
        self._stack.append(bucket)
        self._events[bucket] += 1
        self._open_t = now

    def _exit(self, bucket):
        now = time.monotonic()
        top = self._stack.pop() if self._stack else bucket
        self._secs[top] += now - self._open_t
        self._open_t = now if self._stack else None
        if top == 'metric_drain':
            # the Speedometer/epoch drain cadence doubles as the live
            # publish tick: goodput.* carry a current picture mid-fit,
            # not only the end-of-fit one
            self.publish()

    def charge(self, bucket, seconds, event=True):
        """Retroactive charge of ``seconds`` to ``bucket`` (the
        capture detector, :func:`traced_dispatch`): the time was otherwise headed for the
        productive remainder.  Must not be used under an open
        :meth:`account` region (it would double-charge); the dispatch
        sites that use it have none."""
        if not self.owner() or seconds <= 0:
            return
        self._secs[bucket] += seconds
        if event:
            self._events[bucket] += 1

    def accounted_secs(self):
        """Total seconds already attributed to ANY bucket — the
        baseline :class:`_TracedDispatch` subtracts so a nested
        :meth:`account` region (the AOT lower+compile, a warmup-pool
        wait) is never charged a second time by the enclosing
        trace-detector span."""
        return sum(self._secs.values())

    def note_health(self, monitor):
        """Record the health monitor's skipped-step totals before fit
        deactivates it — :meth:`close` apportions ``health_skipped``
        from them (skipped steps burned productive-looking wall clock
        training nothing)."""
        if monitor is not None and \
                getattr(monitor, 'action', None) == 'skip_update':
            self._health = (int(monitor.steps), int(monitor.nan_steps))

    # -- snapshot / publish -------------------------------------------------
    def snapshot(self):
        """The ledger as a plain dict: wall/productive seconds, the
        per-bucket seconds and event counts, and the goodput fraction.
        Exact identity: ``wall == productive + sum(buckets)``.  Safe to
        call from other threads (flight-recorder dumps from signal
        handlers read live ledgers): the open-region reads are tolerant
        local copies, never a lock the fit thread might hold."""
        now = self._end if self._end is not None else time.monotonic()
        secs = dict(self._secs)
        # racy-but-tolerant: the owner may close the region between
        # these two reads — copy once, guard None, clamp negative
        stack = list(self._stack)
        open_t = self._open_t
        if stack and open_t is not None:
            # an open region's elapsed time belongs to its bucket even
            # mid-flight (flight-recorder dumps read live ledgers)
            secs[stack[-1]] += max(0.0, now - open_t)
        wall = max(0.0, now - self._t0)
        badput = sum(secs.values())
        remainder = max(0.0, wall - badput)
        if self._health:
            steps, nans = self._health
            if steps > 0 and nans > 0:
                skipped = remainder * min(1.0, nans / float(steps))
                secs['health_skipped'] += skipped
                remainder -= skipped
        # sum(buckets) may exceed wall only by float dust; productive
        # is clamped, so renormalize the identity through wall
        productive = max(0.0, wall - sum(secs.values()))
        return {'wall_secs': wall,
                'productive_secs': productive,
                'fraction': (productive / wall) if wall > 0 else 0.0,
                'buckets': secs,
                'events': dict(self._events)}

    def publish(self):
        """Write the ledger into the instrument registry as
        ``goodput.*`` gauges (all buckets, zeros included, so consumers
        always see the full schema)."""
        snap = self.snapshot()
        instrument.set_gauge('goodput.fraction', snap['fraction'])
        instrument.set_gauge('goodput.wall_secs', snap['wall_secs'])
        instrument.set_gauge('goodput.productive_secs',
                             snap['productive_secs'])
        for b in BUCKETS:
            instrument.set_gauge('goodput.%s_secs' % b,
                                 snap['buckets'][b])
        return snap

    def close(self):
        """Freeze the ledger at now and publish the final picture."""
        if self._end is None:
            self._end = time.monotonic()
        return self.publish()


class _Account(object):
    __slots__ = ('_ledger', '_bucket')

    def __init__(self, ledger, bucket):
        self._ledger = ledger
        self._bucket = bucket

    def __enter__(self):
        self._ledger._enter(self._bucket)
        return self

    def __exit__(self, *exc):
        self._ledger._exit(self._bucket)
        return False


class _TracedDispatch(object):
    """Charge the wrapped region to ``compile`` IFF it captured a CUDA
    graph (the ``compile.traces`` counter moved: the first step of a
    batch signature runs its eager warm-up and records the graph).
    Seconds a nested :meth:`GoodputLedger.account` region already
    attributed are subtracted, so a capturing step never double-charges.
    A step that captured nothing costs two counter reads."""
    __slots__ = ('_ledger', '_ctr', '_mark', '_t0', '_acct0')

    def __init__(self, ledger):
        self._ledger = ledger

    def __enter__(self):
        self._ctr = instrument.counter('compile.traces')
        self._mark = self._ctr.value
        self._acct0 = self._ledger.accounted_secs()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._ctr.value != self._mark:
            elapsed = time.monotonic() - self._t0
            nested = self._ledger.accounted_secs() - self._acct0
            self._ledger.charge('compile', elapsed - nested)
        return False


_ledger = None
_ledger_lock = threading.Lock()   # guards begin/end only, never hot
_last_snapshot = None


def goodput_begin():
    """Open a fresh ledger owned by the calling thread (fit start) —
    UNCONDITIONAL replace (tests, standalone scripts).  Fits go through
    :func:`activate_fit`, whose open is atomic and yields to a live
    ledger."""
    global _ledger
    with _ledger_lock:
        _ledger = GoodputLedger() if _on else None
        return _ledger


def goodput_end(token=None):
    """Close and publish the active ledger (fit end — success or
    unwind); keeps the final snapshot for :func:`goodput_snapshot`.
    With ``token`` (what :func:`activate_fit` returned), closes ONLY
    when the active ledger is that token — the no-op for a fit that
    never opened one (plane off, or an outer fit's ledger was live).
    Without a token: unconditional close of whatever is active (tests,
    standalone scripts)."""
    global _ledger, _last_snapshot
    with _ledger_lock:
        if token is not None and _ledger is not token:
            return _last_snapshot
        ledger, _ledger = _ledger, None
    if ledger is not None:
        _last_snapshot = ledger.close()
    return _last_snapshot


def goodput_ledger():
    return _ledger


def goodput_snapshot():
    """The live ledger's snapshot (mid-fit — what flight-recorder dumps
    embed), else the last finished fit's, else {}."""
    ledger = _ledger
    if ledger is not None:
        return ledger.snapshot()
    return _last_snapshot or {}


def account(bucket):
    """Attribute the wrapped region's wall time to goodput bucket
    ``bucket`` — the shared no-op when no ledger is active or the
    caller is not the fit thread (exclusivity guard)."""
    ledger = _ledger
    if ledger is None or not ledger.owner():
        return _NULL
    return _Account(ledger, bucket)


def charge(bucket, seconds):
    """Retroactive charge (see :meth:`GoodputLedger.charge`)."""
    ledger = _ledger
    if ledger is not None:
        ledger.charge(bucket, seconds)


def traced_dispatch():
    """Wrap a fit step: its elapsed time is charged to the ``compile``
    bucket when the step captured a graph (a new batch signature) — a
    replay of a captured step stays in the productive remainder."""
    ledger = _ledger
    if ledger is None or not ledger.owner():
        return _NULL
    return _TracedDispatch(ledger)


def note_health(monitor):
    """Forward the per-fit health monitor to the active ledger before
    fit deactivates it (one None check when off).  Owner-gated like
    account()/charge(): a concurrent-thread fit's monitor must not
    overwrite this ledger's health record (the token gate in
    BaseModule.fit additionally keeps same-thread NESTED fits out)."""
    ledger = _ledger
    if ledger is not None and ledger.owner():
        ledger.note_health(monitor)


refresh()
