"""Communication-attribution plane — per-step collective accounting, the
comm-vs-compute roofline split, cross-rank step cadence; the port of
``mxnet_tpu/commwatch.py``.

1. **Collective accounting.**  The reference parses the compiled
   program's HLO text for its collectives (XLA's SPMD partitioner placed
   them there).  The port issues its collectives itself
   (``parallel/collectives.py``: the mesh step's BatchNorm all-reduces, its
   ZeRO reduce-scatter and all-gather, the tp all-gather), so they are
   COUNTED where they are issued: :func:`note_collective` records each
   one's kind (the reference's HLO names: all-reduce, all-gather,
   reduce-scatter), result payload bytes, group size and, measured on
   the host with the card synchronised before and after, its seconds.
   Per kind it keeps running totals (``comm.<kind>.{count,bytes,
   wire_bytes,seconds}`` gauges); the collectives of the step in flight
   (:func:`step_begin` .. :func:`on_step`) become that step's program row
   (``comm.<kind>[<key>].{count,bytes}``, :func:`programs`), and its wire
   total is ``comm.bytes_per_step``.  Wire bytes are the ring-schedule
   model (:func:`wire_bytes`).

2. **Comm-vs-compute roofline split.**  :func:`on_step` (called from
   ``perfwatch.note_step``) models one step as a compute leg (per-device
   FLOPs over the card's peak, ``perfwatch.PEAKS``) plus a communication
   leg (wire bytes over the interconnect peak, :func:`interconnect_bw`)
   and publishes ``perf.comm_fraction`` = t_comm / (t_comm + t_compute),
   in [0, 1].

3. **Cross-rank step cadence.**  Every step's dispatch-to-dispatch
   interval lands in the ``comm.step_time`` histogram and every dist
   barrier's wait in ``comm.barrier_wait`` (:func:`barrier_wait`); both
   ride the heartbeat telemetry to the kv server, whose merged view
   derives ``cluster.step_skew`` and calls ``health.note_skew``.

The interconnect peak table (:data:`ICI_PEAKS`) holds a nominal host
figure for the CPU only: ranks that share one card reduce over gloo
through the host, and no card's fabric figure was measured.
``MXTPU_PEAK_BW`` pins the peak; a card without an entry falls back to
the host figure with one warning.

Off by default: every hook is one module-global check.
``MXTPU_COMMWATCH=1`` implies the metrics registry, as ``MXTPU_PERFWATCH``
does.
"""
from __future__ import annotations

import logging
import sys
import threading

from . import config, instrument, perfwatch

__all__ = [
    'enabled', 'set_enabled', 'refresh', 'activate_fit',
    'ICI_PEAKS', 'DEFAULT_PEAK_KEY', 'interconnect_bw',
    'COLLECTIVE_KINDS', 'wire_bytes', 'note_collective',
    'collective_stats', 'step_begin', 'step_records', 'program_info',
    'programs', 'clear_programs',
    'comm_fraction', 'on_step', 'barrier_wait',
]

# Peak interconnect bytes/sec per device kind, the denominator of the
# communication leg (the sibling of perfwatch.PEAKS).  The CPU entry is a
# nominal shared-memory figure, so perf.comm_fraction stays defined (not
# meaningful) in CPU tests; it is also the fallback.
ICI_PEAKS = {
    'cpu': 10e9,
}
DEFAULT_PEAK_KEY = 'cpu'

COLLECTIVE_KINDS = ('all-reduce', 'all-gather', 'reduce-scatter',
                    'all-to-all', 'collective-permute')

_on = False
_lock = threading.Lock()

# kind -> [count, bytes, wire_bytes, seconds] since the plane came on
_totals = {}
# the collectives of the step in flight: [(kind, bytes, group, seconds)]
_step = []
# (kind, keystr) -> program row of the last step of that signature
_programs = {}


# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------

def refresh():
    """(Re)read MXTPU_COMMWATCH.  Called at import and per fit
    (``perfwatch.activate_fit``)."""
    set_enabled(config.get('MXTPU_COMMWATCH'))


def set_enabled(on):
    """Runtime toggle (tests; equivalent to exporting MXTPU_COMMWATCH)."""
    global _on
    _on = bool(on)
    perfwatch._comm_on = _on
    if _on and not instrument.metrics_enabled():
        instrument.set_metrics(True)


def enabled():
    return _on


def activate_fit():
    """Per-fit activation (``perfwatch.activate_fit``): re-read the knob
    and start the step accounting afresh."""
    refresh()
    with _lock:
        del _step[:]


# ---------------------------------------------------------------------------
# Interconnect peaks
# ---------------------------------------------------------------------------

_warned_fallback_bw = False


def interconnect_bw(kind=None):
    """Peak interconnect bytes/sec for the communication leg: the
    MXTPU_PEAK_BW override when set, else :data:`ICI_PEAKS` by device
    kind (``perfwatch._live_device_kind``; the CPU's is 'cpu').  A kind
    not in the table falls back to the host figure and warns once: a
    comm_fraction against the wrong fabric must not be silently wrong."""
    global _warned_fallback_bw
    override = float(config.get('MXTPU_PEAK_BW'))
    if override > 0:
        return override
    if kind is None:
        kind = perfwatch._live_device_kind()
    for key, bw in ICI_PEAKS.items():
        if str(kind).startswith(key):
            return bw
    if not _warned_fallback_bw:
        _warned_fallback_bw = True
        logging.warning(
            'mxtpu commwatch: device kind %r not in the interconnect peak '
            'table — perf.comm_fraction uses the %s figure (%.3g B/s); set '
            'MXTPU_PEAK_BW to pin it', kind, DEFAULT_PEAK_KEY,
            ICI_PEAKS[DEFAULT_PEAK_KEY])
    return ICI_PEAKS[DEFAULT_PEAK_KEY]


# ---------------------------------------------------------------------------
# Leg 1: collective accounting
# ---------------------------------------------------------------------------

def wire_bytes(kind, nbytes, group):
    """Analytic per-device wire traffic of ONE execution of a collective
    whose result payload is ``nbytes`` over a group of ``group`` ranks —
    the ring-schedule model:

    - all-reduce: ``2·N·(g-1)/g`` (reduce-scatter + all-gather halves);
    - all-gather: the result is the GATHERED tensor, each rank receives
      the other ``g-1`` shards → ``N·(g-1)/g``;
    - reduce-scatter: the result is one SHARD, each rank sends ``g-1``
      shard-sized messages → ``N·(g-1)``;
    - all-to-all: every rank exchanges ``(g-1)/g`` of its payload;
    - collective-permute: the payload crosses one link once.
    """
    g = max(1, int(group))
    n = float(nbytes)
    if g == 1:
        return 0.0 if kind != 'collective-permute' else n
    if kind == 'all-reduce':
        return 2.0 * n * (g - 1) / g
    if kind == 'all-gather':
        return n * (g - 1) / g
    if kind == 'reduce-scatter':
        return n * (g - 1)
    if kind == 'all-to-all':
        return n * (g - 1) / g
    if kind == 'collective-permute':
        return n
    return 0.0


def _kind_gauge(ckind):
    return 'comm.' + ckind.replace('-', '_')


def note_collective(kind, nbytes, group, seconds=None):
    """One collective issued (``parallel/collectives.py``): its kind,
    result payload bytes, group size and, when timed, seconds.  Adds to
    the running totals and to the step in flight.  One flag check when
    off."""
    if not _on:
        return
    wire = wire_bytes(kind, nbytes, group)
    with _lock:
        t = _totals.setdefault(kind, [0, 0.0, 0.0, 0.0])
        t[0] += 1
        t[1] += float(nbytes)
        t[2] += wire
        t[3] += float(seconds or 0.0)
        _step.append((kind, float(nbytes), int(group),
                      float(seconds or 0.0)))
        c, b, w, s = t
    g = _kind_gauge(kind)
    instrument.set_gauge(g + '.count', c)
    instrument.set_gauge(g + '.bytes', b)
    instrument.set_gauge(g + '.wire_bytes', w)
    instrument.set_gauge(g + '.seconds', s)


def collective_stats(records):
    """Aggregate ``[(kind, bytes, group[, seconds])]`` per kind:
    ``{kind: {'count', 'bytes', 'wire_bytes', 'seconds'}}`` (bytes =
    result payload, wire_bytes = analytic per-device traffic)."""
    stats = {}
    for rec in records:
        kind, nbytes, group = rec[:3]
        s = stats.setdefault(kind, {'count': 0, 'bytes': 0.0,
                                    'wire_bytes': 0.0, 'seconds': 0.0})
        s['count'] += 1
        s['bytes'] += nbytes
        s['wire_bytes'] += wire_bytes(kind, nbytes, group)
        s['seconds'] += rec[3] if len(rec) > 3 else 0.0
    return stats


def step_begin():
    """A step starts: its collectives are counted afresh."""
    if not _on:
        return
    with _lock:
        del _step[:]


def step_records():
    """The collectives counted since :func:`step_begin`."""
    with _lock:
        return list(_step)


def _record_program(kind, key):
    """The step just dispatched becomes its signature's program row."""
    kind = str(kind)
    keystr = perfwatch._keystr(key)
    info = perfwatch.executable_info(kind, key) or {}
    stats = collective_stats(step_records())
    row = {'kind': kind, 'key': keystr,
           'num_devices': max(1, int(info.get('num_devices', 1))),
           'collectives': stats,
           'wire_bytes_per_step': sum(s['wire_bytes']
                                      for s in stats.values()),
           'seconds_per_step': sum(s['seconds'] for s in stats.values())}
    with _lock:
        _programs[(kind, keystr)] = row
        nprog = len(_programs)
    for ck, s in stats.items():
        g = _kind_gauge(ck)
        instrument.set_gauge('%s[%s].count' % (g, keystr), s['count'])
        instrument.set_gauge('%s[%s].bytes' % (g, keystr), s['bytes'])
    instrument.set_gauge('comm.executables', nprog)
    instrument.set_gauge('xla.%s[%s].comm_wire_bytes' % (kind, keystr),
                         row['wire_bytes_per_step'])
    return row


def program_info(kind, key):
    with _lock:
        row = _programs.get((str(kind), perfwatch._keystr(key)))
        return dict(row) if row else None


def programs():
    """Snapshot of every program row (report/forensics)."""
    with _lock:
        return [dict(v) for v in _programs.values()]


def clear_programs():
    with _lock:
        _programs.clear()
        _totals.clear()
        del _step[:]


# ---------------------------------------------------------------------------
# Leg 2+3: per-step roofline split + cross-rank cadence
# ---------------------------------------------------------------------------

def comm_fraction(wire_bytes_step, flops_per_device, peak_flops=None,
                  peak_bw=None):
    """t_comm / (t_comm + t_compute) for one step: the fraction of an
    ideally-overlapped step that the interconnect leg needs.  0.0 when
    the step moves no collective bytes, 1.0 when it does nothing else;
    by construction always in [0, 1]."""
    peak_bw = peak_bw if peak_bw else interconnect_bw()
    peak_flops = peak_flops if peak_flops else perfwatch.peak_flops()
    t_comm = float(wire_bytes_step) / peak_bw if peak_bw else 0.0
    t_comp = float(flops_per_device) / peak_flops if peak_flops else 0.0
    total = t_comm + t_comp
    return t_comm / total if total > 0 else 0.0


def on_step(kind, key, interval, flops_per_device):
    """One step dispatched (``perfwatch.note_step`` with this plane on):
    the dispatch-to-dispatch interval into the ``comm.step_time``
    histogram, the step's collectives into its program row, and
    ``comm.bytes_per_step`` / ``comm.seconds_per_step`` /
    ``perf.comm_fraction`` from them."""
    if not _on:
        return
    if interval is not None and interval > 0:
        instrument.observe_hist('comm.step_time', interval)
    if key is None:
        return
    row = _record_program(kind, key)
    wire = row['wire_bytes_per_step']
    instrument.set_gauge('comm.bytes_per_step', wire)
    instrument.set_gauge('comm.seconds_per_step', row['seconds_per_step'])
    instrument.set_gauge('perf.comm_fraction',
                         comm_fraction(wire, flops_per_device))


def barrier_wait(seconds):
    """One dist-barrier wait completed: the ``comm.barrier_wait``
    histogram and the ``comm.barriers`` counter (the cross-rank
    wait-time signal of the straggler story).  One flag check when off."""
    if not _on:
        return
    instrument.observe_hist('comm.barrier_wait', seconds)
    instrument.inc('comm.barriers')


# register with perfwatch: its activate_fit / note_step consult this
# module through the _comm hook (perfwatch cannot import it at its top:
# this direction breaks the cycle)
perfwatch._comm = sys.modules[__name__]
refresh()
