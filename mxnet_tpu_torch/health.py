"""The crash flight recorder — the ``FlightRecorder`` half of
``mxnet_tpu/health.py``.

A bounded ring of recent spans (the instrument thread buffers, read
without draining them) plus a metrics snapshot, the recent decision
events and the dropped-span totals, committed atomically
(``resilience.atomic_replace``) so a crash mid-dump leaves the previous
record intact.  :func:`install_flight_recorder` (``MXTPU_FLIGHT_RECORDER
=<dir>``) turns span tracing on and dumps from atexit, SIGTERM/SIGABRT
(chained to the previous handlers) and every ``MXTPU_FAULTS``-injected
kill (``resilience.on_kill``); the serving plane dumps through it on a
drain and for each servewatch postmortem.

The record's ``'health'`` key holds ``{}``: the training sentinels that
fill it in the reference (``HealthMonitor``) are not ported yet, and
``{}`` is the reference's own value when no monitor is active.  There is
no ``'goodput'`` key either, the reference's branch when no goodput
ledger exists (its input-pipeline plane is not ported yet).
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import re
import signal
import threading
import time

from . import config, instrument, resilience

__all__ = ['FlightRecorder', 'flight_recorder', 'dump_flight',
           'install_flight_recorder']

_log = logging.getLogger('mxnet_tpu_torch.health')


class FlightRecorder(object):
    """Bounded postmortem recorder: the last ``ring`` spans plus a
    metrics snapshot and the dropped-span totals, committed atomically
    to ``flightrec-rank<R>.json`` in ``dirpath``."""

    def __init__(self, dirpath, ring=None, every=None):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.ring = int(ring if ring is not None
                        else config.get('MXTPU_FLIGHT_RECORDER_RING'))
        self.every = max(1, int(every if every is not None
                         else config.get('MXTPU_FLIGHT_RECORDER_EVERY')))
        self.rank = os.environ.get('MXTPU_PROCESS_ID', '0')
        self.path = os.path.join(dirpath,
                                 'flightrec-rank%s.json' % self.rank)
        self._drains = 0
        # RLock: a SIGTERM can land while the main thread is inside a
        # dump, and the handler dumps again on the same thread
        self._lock = threading.RLock()

    def tick(self):
        """One drain elapsed; every ``every``-th writes the write-ahead
        snapshot."""
        self._drains += 1
        if self._drains % self.every == 0:
            self.dump('periodic')

    def durable_path(self, reason):
        """The per-reason record :meth:`dump` commits when given an
        ``extra`` payload; characters outside ``[A-Za-z0-9._-]`` fold to
        ``_`` so a reason cannot escape the directory."""
        safe = re.sub(r'[^A-Za-z0-9._-]+', '_', str(reason))
        return os.path.join(self.dir, 'flightrec-rank%s-%s.json'
                            % (self.rank, safe))

    def _collect(self, timeout=2.0):
        """Read spans, metrics and decisions on a helper thread, joined
        with a timeout: a signal handler runs between bytecodes, and if
        the interrupted frame holds a registry lock an inline read would
        deadlock.  Past the timeout the record is marked partial."""
        box = {'spans': [], 'metrics': {}, 'dropped_events': 0,
               'decisions': []}

        def read():
            box['dropped_events'] = instrument.dropped_totals()
            box['spans'] = instrument.recent_events(self.ring)
            box['metrics'] = instrument.metrics_snapshot()
            box['decisions'] = instrument.recent_decisions(64)

        t = threading.Thread(target=read, daemon=True,
                             name='mxtpu-torch-flight-collect')
        t.start()
        t.join(timeout)
        if t.is_alive():
            box['partial'] = True
        return box

    def dump(self, reason, extra=None):
        """Write the record; best-effort, since it runs from signal
        handlers, atexit and kill sites.  ``extra`` rides under the
        reason's key, and the record is then ALSO committed to
        :meth:`durable_path`, which a later 'exit' dump does not
        overwrite.  Returns the path, or None when the write failed."""
        with self._lock:
            try:
                doc = {'schema': 'mxtpu-flight-recorder-1',
                       'reason': reason,
                       'time': time.time(),
                       'pid': os.getpid(),
                       'rank': self.rank,
                       'drains': self._drains,
                       'health': {}}
                if extra is not None:
                    doc[str(reason)] = extra
                doc.update(self._collect())
                with resilience.atomic_replace(self.path) as tmp:
                    with open(tmp, 'w') as f:
                        json.dump(doc, f, default=str)
                if extra is not None:
                    with resilience.atomic_replace(
                            self.durable_path(reason)) as tmp:
                        with open(tmp, 'w') as f:
                            json.dump(doc, f, default=str)
                instrument.inc('health.flight_dumps')
                return self.path
            except Exception:        # noqa: BLE001 - never raise here
                _log.warning('flight-recorder dump failed', exc_info=True)
                return None


_recorder = None
_prev_handlers = {}


def flight_recorder():
    return _recorder


def dump_flight(reason, extra=None):
    """Dump the installed flight recorder (no-op when none)."""
    rec = _recorder
    if rec is not None:
        return rec.dump(reason, extra=extra)
    return None


def _atexit_dump():
    dump_flight('exit')


def _kill_dump():
    dump_flight('injected-kill')


def _on_signal(signum, frame):
    dump_flight('signal-%d' % signum)
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    if prev is signal.SIG_IGN:
        return
    # the default disposition, re-raised: the process still dies of it
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _install_signal_hooks():
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGABRT):
        try:
            prev = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            continue
        if prev is not _on_signal:
            _prev_handlers[sig] = prev


def install_flight_recorder(dirpath=None, ring=None, every=None):
    """Install (or return the installed) flight recorder.  ``dirpath``
    defaults to ``MXTPU_FLIGHT_RECORDER``; none: no-op, None returned.
    Installing turns span tracing on and hooks atexit, SIGTERM/SIGABRT
    and the fault-injection kill sites."""
    global _recorder
    if dirpath is None:
        dirpath = config.get('MXTPU_FLIGHT_RECORDER') or None
    if not dirpath:
        return None
    if _recorder is not None and _recorder.dir == dirpath:
        return _recorder
    _recorder = FlightRecorder(dirpath, ring=ring, every=every)
    instrument.set_profiling(True)
    atexit.register(_atexit_dump)
    _install_signal_hooks()
    resilience.on_kill(_kill_dump)
    return _recorder
