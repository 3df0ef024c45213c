"""Training-health plane — on-device sentinels, divergence actions and
the crash flight recorder; the port of ``mxnet_tpu/health.py``.

- **On-device sentinels** (``MXTPU_HEALTH_SENTINELS``): probes folded
  into the fused fit step by ``parallel.train_step.make_fit_step`` — a
  global non-finite flag over the outputs and gradients, the global
  gradient norm and the update-to-weight ratio.  The reference threads
  them through its compiled program as donated device scalars; here they
  fold IN PLACE into two fixed device buffers per device (int32
  ``(steps, nan_steps, first_bad, last_bad)`` and float32 ``(grad_norm,
  update_ratio)``), which a captured step's graph holds and every replay
  updates, so nothing is read back per step.  The host reads them only at
  the existing metric drains: ``metric.EvalMetric._drain_device`` takes
  them into its one batched copy (:func:`_piggyback_take` /
  :func:`_piggyback_apply`), so ``health.host_syncs`` stays 0 in steady
  state.  ``MXTPU_HEALTH_ACTION`` picks what a detected bad step
  triggers: ``warn`` (log), ``skip_update`` (the step is masked on the
  device: parameters, optimizer state, aux and the metric stay bit for
  bit at their values before it) or ``abort`` (raise
  :class:`TrainingDivergedError` with the offending step range).
- **Flight recorder** (``MXTPU_FLIGHT_RECORDER=<dir>``): a bounded ring
  of recent spans (the instrument thread buffers, read without draining
  them) plus a metrics snapshot, the recent decision events, the
  dropped-span totals, the active monitor's values (``'health'``) and
  the goodput ledger (``'goodput'``), committed atomically
  (``resilience.atomic_replace``) from atexit, SIGTERM/SIGABRT (chained
  to the previous handlers), every ``MXTPU_FAULTS``-injected kill
  (``resilience.on_kill``), a :class:`TrainingDivergedError`, and as a
  write-ahead snapshot every ``MXTPU_FLIGHT_RECORDER_EVERY`` drains.  It
  is installed on first use or by :func:`install_flight_recorder`, not
  at import as in the reference.

- **Cross-rank straggler threshold** (``MXTPU_SKEW_WARN_PCT``):
  :func:`note_skew`, called by the kv server whenever its merged
  telemetry view names a slowest rank, logs the laggard and commits a
  ``skew`` flight record, at most once per 30 s per rank.  The elastic
  plane's hooks (``note_cluster_alert``, ``cluster_diverged_error``) come
  with ``elastic.py``, their only caller.
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

import torch

from . import config, instrument, resilience
from .base import MXNetError

__all__ = [
    'TrainingDivergedError', 'HealthMonitor', 'FlightRecorder',
    'sentinels_on', 'health_action',
    'activate', 'deactivate', 'active_monitor', 'fold_key', 'last_values',
    'all_finite_tree', 'l2_norm_tree', 'update_ratio',
    'init_state', 'fold_state',
    'install_flight_recorder', 'flight_recorder', 'dump_flight',
    'note_skew',
]

_log = logging.getLogger('mxnet_tpu_torch.health')

_ACTIONS = ('warn', 'skip_update', 'abort')

# the wire form of the configured action (the health.action_level gauge)
_ACTION_LEVEL = {'warn': 0, 'skip_update': 1, 'abort': 2}


class TrainingDivergedError(MXNetError):
    """Raised (under ``MXTPU_HEALTH_ACTION=abort``) when the on-device
    sentinels saw a non-finite output or gradient.  Carries the
    offending step range in fused-step indices (0-based, monotonic
    across epochs within one ``fit``)."""

    def __init__(self, first_bad_step, last_bad_step, nan_steps,
                 grad_norm=float('nan')):
        self.first_bad_step = int(first_bad_step)
        self.last_bad_step = int(last_bad_step)
        self.nan_steps = int(nan_steps)
        self.grad_norm = float(grad_norm)
        super().__init__(
            'training diverged: non-finite loss/gradients in %d step(s), '
            'steps %d..%d (last grad_norm=%.4g)'
            % (self.nan_steps, self.first_bad_step, self.last_bad_step,
               self.grad_norm))


def sentinels_on():
    return bool(config.get('MXTPU_HEALTH_SENTINELS'))


def health_action():
    action = str(config.get('MXTPU_HEALTH_ACTION')).strip().lower()
    if action not in _ACTIONS:
        raise ValueError('MXTPU_HEALTH_ACTION must be one of %s, got %r'
                         % (_ACTIONS, action))
    return action


# ---------------------------------------------------------------------------
# Probes on tensors (run inside the fused step, recorded by its graph)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    for t in tree or ():
        out.extend(_leaves(t))
    return out


def _floating(tree):
    return [t for t in _leaves(tree) if t.is_floating_point()]


def all_finite_tree(tree):
    """0-dim bool tensor: every element of every floating leaf is finite.
    The largest magnitude of each leaf (``_foreach_norm`` of order inf,
    which propagates NaN) is checked, never a sum of squares: finite
    large values whose squares overflow are still finite."""
    leaves = [t for t in _floating(tree) if t.numel()]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    peaks = torch._foreach_norm(leaves, float('inf'))
    return torch.isfinite(torch.stack([p.float() for p in peaks])).all()


def l2_norm_tree(tree):
    """Global L2 norm over every floating leaf, in float32."""
    leaves = [t.float() for t in _floating(tree) if t.numel()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(leaves, 2)))


def update_ratio(old_params, new_params):
    """``||new - old|| / (||old|| + 1e-12)`` over the parameters — the
    update-to-weight ratio, the classic learning-rate health signal."""
    new, old = _floating(new_params), _floating(old_params)
    delta = torch._foreach_sub([t.float() for t in new],
                               [t.float() for t in old]) if new else []
    return l2_norm_tree(delta) / (l2_norm_tree(old) + 1e-12)


def init_state(device=None):
    """Fresh health state: int32 ``(steps, nan_steps, first_bad,
    last_bad)`` (first/last start at -1) and float32 ``(grad_norm,
    update_ratio)``."""
    return (torch.tensor([0, 0, -1, -1], dtype=torch.int32, device=device),
            torch.zeros(2, dtype=torch.float32, device=device))


def fold_state(state, ok, grad_norm, ratio):
    """One step's fold of the probe results into ``state``, IN PLACE
    (the buffers a captured step holds); returns ``state``."""
    ints, floats = state
    bad = torch.logical_not(ok)
    steps, first = ints[0], ints[2]
    new = torch.stack([
        steps + 1,
        ints[1] + bad.to(torch.int32),
        torch.where(torch.logical_and(bad, first < 0), steps, first),
        torch.where(bad, steps, ints[3])])
    ints.copy_(new)
    floats.copy_(torch.stack([grad_norm.float().reshape(()),
                              ratio.float().reshape(())]))
    return state


# ---------------------------------------------------------------------------
# Host-side monitor
# ---------------------------------------------------------------------------

# one health state per device for the life of the process: captured
# steps hold their addresses, and each fit's monitor resets them in place
_buffers = {}


def _device_buffers(device):
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    buf = _buffers.get(device)
    if buf is None:
        buf = _buffers[device] = init_state(device)
    return buf


class HealthMonitor(object):
    """One fit's health accumulator.  :meth:`device_state` hands the fused
    step the device's state buffers (reset in place on this monitor's
    first call); :meth:`set_device_state` marks them pending after a
    step.  Draining rides the metric drain (``metric.EvalMetric.
    _drain_device`` copies these tensors in the SAME transfer), so
    steady-state fits pay no extra host sync; a standalone :meth:`drain`
    counts ``health.host_syncs``."""

    def __init__(self, action='warn'):
        assert action in _ACTIONS, action
        self.action = action
        self._dev = None
        self._dirty = False
        # drained host mirrors (Speedometer's health column reads these
        # without ever touching the device)
        self.steps = 0
        self.nan_steps = 0
        self.first_bad_step = -1
        self.last_bad_step = -1
        self.grad_norm = 0.0
        self.update_ratio = 0.0
        self._nan_reported = 0
        self._warned_unfused = False

    def warn_unfused(self):
        """Called by the fit loop when a step takes the non-fused path:
        the sentinels only ride the fused step, so a configured
        skip_update/abort would silently never fire — say so, once per
        fit."""
        if self._warned_unfused:
            return
        self._warned_unfused = True
        _log.warning(
            'mxtpu health: MXTPU_HEALTH_SENTINELS is on but this fit is '
            'not using the fused train step (monitor, non-functional '
            'optimizer, or MXTPU_FUSED_FIT=0) — the on-device probe is '
            'INACTIVE and MXTPU_HEALTH_ACTION=%r will not fire',
            self.action)

    # -- the fused-step side ------------------------------------------------
    def device_state(self, device):
        """The state buffers on ``device``; the first call of this monitor
        resets them to :func:`init_state`'s values, in place."""
        buf = _device_buffers(device)
        if self._dev is not buf:
            self._dev = buf
            with torch.no_grad():
                for t, f in zip(buf, init_state(buf[0].device)):
                    t.copy_(f)
        return buf

    def set_device_state(self, state):
        self._dev = state
        self._dirty = True

    def pending_arrays(self):
        """Device tensors awaiting a drain (empty when no step ran since
        the last apply)."""
        if self._dev is None or not self._dirty:
            return []
        return list(self._dev)

    # -- the drain side -----------------------------------------------------
    def apply_drained(self, values):
        """Fold the drained values (``steps, nan_steps, first_bad,
        last_bad, grad_norm, update_ratio`` as host numbers) into the host
        mirrors and the instrument registry.  Returns the number of NEW
        bad steps since the previous apply."""
        steps, nans, first, last, gnorm, ratio = values
        self.steps = int(steps)
        self.nan_steps = int(nans)
        self.first_bad_step = int(first)
        self.last_bad_step = int(last)
        self.grad_norm = float(gnorm)
        self.update_ratio = float(ratio)
        self._dirty = False
        if instrument.metrics_enabled():
            instrument.set_gauge('health.grad_norm', self.grad_norm)
            instrument.set_gauge('health.update_ratio', self.update_ratio)
            instrument.set_gauge('health.steps', self.steps)
            instrument.set_gauge('health.action_level',
                                 _ACTION_LEVEL.get(self.action, 0))
            # materialize the counter even on all-clear drains so a
            # postmortem snapshot always carries health.*
            instrument.counter('health.nan_steps')
        delta = self.nan_steps - self._nan_reported
        if delta > 0:
            instrument.inc('health.nan_steps', delta)
        self._nan_reported = self.nan_steps
        return delta

    def act(self, new_bad):
        """Apply the configured divergence action for ``new_bad`` newly
        drained bad steps (no-op when 0)."""
        if new_bad <= 0:
            return
        reason = 'non-finite loss/gradients in %d step(s), steps %d..%d' \
            % (new_bad, self.first_bad_step, self.last_bad_step)
        if self.action == 'abort':
            instrument.decision('health', 'abort', severity='error',
                                reason=reason, nan_steps=self.nan_steps)
            dump_flight('diverged')
            raise TrainingDivergedError(self.first_bad_step,
                                        self.last_bad_step,
                                        self.nan_steps, self.grad_norm)
        skipped = ' — update(s) skipped on the device' \
            if self.action == 'skip_update' else ''
        instrument.decision(
            'health',
            'skip_update' if self.action == 'skip_update' else 'warn',
            severity='warn', reason=reason, nan_steps=self.nan_steps)
        _log.warning(
            'mxtpu health: non-finite loss/gradients in %d step(s), '
            'steps %d..%d (grad_norm=%.4g)%s', new_bad,
            self.first_bad_step, self.last_bad_step, self.grad_norm,
            skipped)

    def drain(self):
        """Standalone drain (NOT the steady-state path): copies the
        pending state itself and counts ``health.host_syncs``."""
        arrays = self.pending_arrays()
        if not arrays:
            return
        from . import iowatch
        with iowatch.account('metric_drain'):
            values = _read(arrays)
        instrument.inc('health.host_syncs')
        self.act(self.apply_drained(values))

    def values(self):
        """Drained host mirrors as a plain dict — safe to read anywhere,
        never touches the device."""
        return {'steps': self.steps, 'nan_steps': self.nan_steps,
                'first_bad_step': self.first_bad_step,
                'last_bad_step': self.last_bad_step,
                'grad_norm': self.grad_norm,
                'update_ratio': self.update_ratio}


def _read(arrays):
    """Host values of the state tensors, in one transfer."""
    return torch.cat([a.double().reshape(-1) for a in arrays]).cpu() \
        .tolist()


_active = None            # the fitting module's monitor, or None


def activate():
    """Install a fresh monitor for the duration of one ``fit`` (called
    by ``BaseModule.fit``; None with sentinels off)."""
    global _active
    _active = HealthMonitor(health_action()) if sentinels_on() else None
    return _active


def deactivate():
    global _active
    _active = None


def active_monitor():
    return _active


def fold_key():
    """Identity of the health computation folded into the fused step
    (None = no sentinels): a toggle between fits rebuilds the step."""
    return _active.action if _active is not None else None


def last_values():
    """The active monitor's drained values ({} when no fit is running
    with sentinels on).  Reads host mirrors only."""
    return _active.values() if _active is not None else {}


# -- the metric-drain piggyback (called from metric._drain_device) -----------

_EMPTY = ()


def _piggyback_take():
    """Tensors the metric drain copies in ITS transfer (empty when no
    monitor is active or nothing ran since the last apply)."""
    mon = _active
    if mon is None:
        return _EMPTY
    return mon.pending_arrays()


def _piggyback_apply(taken, values=None):
    """After the metric's transfer: apply the drained health values (no
    transfer of its own, no ``health.host_syncs``) and tick the flight
    recorder's write-ahead cadence.  May raise
    :class:`TrainingDivergedError`."""
    rec = _recorder
    if rec is not None:
        rec.tick()
    if not taken:
        return
    mon = _active
    if mon is None:
        return
    mon.act(mon.apply_drained(values))


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

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
                       'health': last_values()}
                try:
                    # where the run's wall clock went, up to this
                    # instant: the postmortem's goodput leg
                    from . import iowatch
                    gp = iowatch.goodput_snapshot()
                    if gp:
                        doc['goodput'] = gp
                except Exception:        # noqa: BLE001
                    pass
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


# ---------------------------------------------------------------------------
# Cross-rank straggler threshold (the communication plane's laggard hook)
# ---------------------------------------------------------------------------

# rank -> monotonic time of the last warning, so a persistent laggard logs
# once per window instead of once per heartbeat merge
_skew_warned = {}
_SKEW_WARN_INTERVAL = 30.0


def note_skew(skew, laggard, now=None):
    """Called by the kv server whenever a merged telemetry view carries a
    straggler attribution (``kvstore_server.compute_step_skew``): when
    the slowest rank's mean step time sits more than
    ``MXTPU_SKEW_WARN_PCT`` percent above the cluster median, log the
    laggard (``health.skew_warnings``) and commit a ``skew`` flight
    record naming it.  Throttled to once per 30 s per rank
    (``_SKEW_WARN_INTERVAL``); never when the knob is 0.  Returns True
    when it warned (``mxnet_tpu/health.py:389-431``)."""
    pct = float(config.get('MXTPU_SKEW_WARN_PCT'))
    if pct <= 0 or laggard is None or skew * 100.0 < pct:
        return False
    rank = laggard.get('rank')
    now = time.monotonic() if now is None else now
    last = _skew_warned.get(rank)
    if last is not None and now - last < _SKEW_WARN_INTERVAL:
        return False
    _skew_warned[rank] = now
    logging.warning(
        'mxtpu health: rank %s is a straggler — mean step %.4gs vs '
        'cluster median %.4gs (%.1f%% over, threshold %.0f%%): check '
        'that host\'s input pipeline / thermals / neighbors',
        rank, laggard.get('mean_step_secs', float('nan')),
        laggard.get('median_step_secs', float('nan')),
        skew * 100.0, pct)
    instrument.inc('health.skew_warnings')
    instrument.decision(
        'health', 'skew_warn', severity='warn',
        reason='rank %s is a straggler — mean step %.4gs vs cluster '
               'median %.4gs (%.1f%% over)'
               % (rank, laggard.get('mean_step_secs', float('nan')),
                  laggard.get('median_step_secs', float('nan')),
                  skew * 100.0),
        rank=rank, skew=skew)
    if flight_recorder() is None:
        install_flight_recorder()      # a no-op without the knob
    dump_flight('skew', extra={'skew': skew, 'laggard': laggard})
    return True
