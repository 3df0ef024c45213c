"""Shared decision machinery — hysteresis gating and robust online
anomaly detection; the port of ``mxnet_tpu/detector.py``.

- :class:`HysteresisGate` — consecutive-evidence thresholds plus a
  post-action settle window.  A breach only fires after ``up_after``
  consecutive breach observations, a clear after ``down_after``; mixed
  evidence resets both streaks; observations inside the ``cooldown_s``
  settle window after an action are consumed WITHOUT hysteresis
  progress (they still carry pre-action stragglers).  The serving
  autoscaler runs on it.
- :class:`RobustBaseline` — rolling median/MAD over a bounded window
  (one anomalous sample must not drag the baseline it is judged
  against).
- :class:`SeriesDetector` — a baseline + gate composed into one online
  detector for a named scalar series, with level (``direction='low'``/
  ``'high'``) and ``'slope'`` (leak) modes.  The baseline FREEZES while
  evidence is breaching; an open anomaly closes after ``clear_after``
  in-band samples, then the detector re-arms.

Pure Python over plain floats — no registry access, no threads, no
clocks of its own (callers pass timestamps), so every path is
deterministic under test.
"""
from __future__ import annotations

import math
import time
from collections import deque

__all__ = ['HysteresisGate', 'RobustBaseline', 'SeriesDetector']


class HysteresisGate(object):
    """Consecutive-evidence gate with a post-action settle window.

    ``observe(breach, clear)`` returns ``'breach'`` when ``up_after``
    consecutive breach observations accumulate, ``'clear'`` after
    ``down_after`` consecutive clears, else None.  The caller reports
    an action taken via :meth:`acted`, which resets the streaks and
    opens the ``cooldown_s`` settle window; :meth:`settling` says
    whether an observation should be consumed without progress (the
    autoscaler's "discard pre-action stragglers" rule).
    """
    __slots__ = ('up_after', 'down_after', 'cooldown_s', 'breaches',
                 'clears', 'last_action_t')

    def __init__(self, up_after=2, down_after=5, cooldown_s=0.0):
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_s = float(cooldown_s)
        self.breaches = 0
        self.clears = 0
        self.last_action_t = 0.0

    def settling(self, now=None):
        """True while inside the post-action settle window."""
        if self.cooldown_s <= 0:
            return False
        now = time.monotonic() if now is None else now
        return now - self.last_action_t < self.cooldown_s

    def reset(self):
        self.breaches = 0
        self.clears = 0

    def acted(self, now=None):
        """An action was taken: reset the streaks and start the settle
        window — the next decision is built only from post-action
        evidence."""
        self.last_action_t = time.monotonic() if now is None else now
        self.reset()

    def observe(self, breach, clear, now=None):
        """Fold one observation.  ``breach``/``clear`` are this tick's
        verdicts on the evidence (both False = inconclusive, which
        resets BOTH streaks).  Returns 'breach' / 'clear' when a streak
        crosses its threshold, else None.  Observations inside the
        settle window are consumed with no progress."""
        if self.settling(now):
            self.reset()
            return None
        if breach:
            self.breaches += 1
            self.clears = 0
            if self.breaches >= self.up_after:
                return 'breach'
        elif clear:
            self.clears += 1
            self.breaches = 0
            if self.clears >= self.down_after:
                return 'clear'
        else:
            self.reset()
        return None


class RobustBaseline(object):
    """Rolling median/MAD over the last ``window`` accepted samples.

    ``mad()`` is floored at ``rel_floor`` of |median| (plus a tiny
    absolute epsilon) so a near-constant series — MAD exactly 0 — does
    not turn every rounding wiggle into an infinite-sigma event."""
    __slots__ = ('window', 'rel_floor', 'values')

    def __init__(self, window=32, rel_floor=0.05):
        self.window = max(4, int(window))
        self.rel_floor = float(rel_floor)
        self.values = deque(maxlen=self.window)

    def __len__(self):
        return len(self.values)

    def add(self, v):
        self.values.append(float(v))

    def median(self):
        if not self.values:
            return 0.0
        s = sorted(self.values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def mad(self):
        """Median absolute deviation, floored (see class docstring)."""
        med = self.median()
        if not self.values:
            return 0.0
        devs = sorted(abs(v - med) for v in self.values)
        n = len(devs)
        mid = n // 2
        raw = devs[mid] if n % 2 else 0.5 * (devs[mid - 1] + devs[mid])
        return max(raw, self.rel_floor * abs(med), 1e-12)


def slope_of(points):
    """Least-squares slope (units/sec) of ``[(t, v), ...]``; 0.0 when
    fewer than two distinct timestamps.  Shared by the leak detector
    and ``chronicle.query``'s trend read."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    num = sum((t - mt) * (v - mv) for t, v in points)
    den = sum((t - mt) ** 2 for t, _ in points)
    return num / den if den > 0 else 0.0


class SeriesDetector(object):
    """Online anomaly detector for one scalar series.

    Level modes (``direction='low'`` or ``'high'``): a sample breaches
    when it sits more than ``k_mad`` MADs outside the rolling
    median on the watched side; ``fire_after`` consecutive breaches
    raise the anomaly (so one noisy sample never fires), and the
    baseline freezes while evidence is breaching.  While an anomaly is
    open, ``clear_after`` consecutive in-band samples close it (an
    ``anomaly_cleared`` verdict) and re-arm the detector; the gate's
    ``settle_s`` window after each verdict discards the transition
    samples.

    Slope mode (``direction='slope'``, the leak detector): the verdict
    is on the least-squares slope of the trailing window — a breach
    when the projected drift over one full window exceeds
    ``slope_frac`` of the current level (both sustained growth and the
    |median| floor make it unit-free).

    ``observe(t, v)`` returns ``('anomaly', info)`` when an anomaly
    fires, ``('cleared', info)`` when one closes, else None.  ``info``
    carries the evidence: value, baseline median/MAD, magnitude in
    MADs, and the offending ``window`` of trailing ``(t, v)`` samples.
    """

    def __init__(self, series, direction='high', window=32,
                 min_samples=8, k_mad=4.0, fire_after=2, clear_after=4,
                 settle_s=0.0, rel_floor=0.05, slope_frac=0.10):
        if direction not in ('low', 'high', 'slope'):
            raise ValueError('direction must be low/high/slope, got %r'
                             % (direction,))
        self.series = series
        self.direction = direction
        self.min_samples = max(2, int(min_samples))
        self.k_mad = float(k_mad)
        self.slope_frac = float(slope_frac)
        self.baseline = RobustBaseline(window=window,
                                       rel_floor=rel_floor)
        self.gate = HysteresisGate(up_after=fire_after,
                                   down_after=clear_after,
                                   cooldown_s=settle_s)
        self.active = False         # an anomaly is currently open
        self.tail = deque(maxlen=self.baseline.window)  # (t, v) trail

    # -- per-mode breach verdict -------------------------------------------

    def _verdict(self, v):
        """(breach, magnitude, med, mad) for one sample under the
        CURRENT baseline."""
        med = self.baseline.median()
        mad = self.baseline.mad()
        if self.direction == 'slope':
            # projected drift over one full baseline window, relative
            # to the current level: a 32-sample window growing >10% of
            # its own median is leaking, whatever the units
            s = slope_of(list(self.tail))
            span = (self.tail[-1][0] - self.tail[0][0]) \
                if len(self.tail) >= 2 else 0.0
            level = max(abs(med), 1e-12)
            drift = s * max(span, 1e-12) / level
            return drift > self.slope_frac, drift, med, mad
        dev = (v - med) / mad
        if self.direction == 'low':
            return dev < -self.k_mad, dev, med, mad
        return dev > self.k_mad, dev, med, mad

    def observe(self, t, v):
        """Fold one sample; see class docstring for the return."""
        v = float(v)
        self.tail.append((t, v))
        armed = len(self.baseline) >= self.min_samples or \
            (self.direction == 'slope'
             and len(self.tail) >= self.min_samples)
        breach = False
        mag = med = mad = 0.0
        if armed:
            breach, mag, med, mad = self._verdict(v)
        # the baseline learns only non-breaching evidence: a sustained
        # anomaly must not become its own new normal before it is even
        # reported.  (Slope mode always learns — the baseline is only
        # the |median| level floor there, not the judged quantity.)
        if not breach or self.direction == 'slope':
            self.baseline.add(v)
        if not armed:
            return None
        verdict = self.gate.observe(breach and not self.active,
                                    (not breach) and self.active,
                                    now=t)
        info = {'series': self.series, 'direction': self.direction,
                't': t, 'value': v, 'baseline': med, 'mad': mad,
                'magnitude': mag, 'window': list(self.tail)}
        if verdict == 'breach' and not self.active:
            self.active = True
            self.gate.acted(now=t)
            return ('anomaly', info)
        if verdict == 'clear' and self.active:
            self.active = False
            self.gate.acted(now=t)
            return ('cleared', info)
        return None
