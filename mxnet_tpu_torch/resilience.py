"""Atomic file commits and fault injection — the port of
``mxnet_tpu/resilience.py``'s ``atomic_replace`` (``:182``), through
which every checkpoint file (``-symbol.json``, ``.params``, ``.states``)
is written, and of its ``MXTPU_FAULTS`` plan (``:235-428``), on which the
serving fleet's supervision drills run.

``MXTPU_FAULTS`` grammar (semicolon-separated directives)::

    site:action[:arg[:arg2]]

    site    prefix-matched against the firing point's name.  The serving
            fleet fires 'serve.execute.r<id>' (inside the replica lock,
            before the forward), 'serve.flush.r<id>' (the batcher's
            flush) and 'serve.worker.r<id>' (the worker loop, a
            thread_kill site).  The kv server and its client fire
            'server.recv', 'server.apply', 'server.barrier',
            'client.send' and 'client.recv' (``kvstore_server.py``).
    action  drop:P        ask the caller to drop, with probability P
            delay:P:SECS  sleep SECS with probability P
            sever:P       raise InjectedFault with probability P
            wedge:P:SECS  sleep SECS with probability P (named for what
                          it simulates: a worker holding its flush)
            after:N:ACT   fire ACT ('drop'|'sever'|'kill') on the Nth
                          matching event (1-based), once;
                          'after:N:wedge:SECS' wedges SECS once
            kill:P        SIGKILL the process; at a site fired with
                          ``thread_kill=True`` raise InjectedDeath
                          instead (the worker dies, the process lives
                          to replace it)

``MXTPU_FAULTS_SEED`` pins the coin flips.  :class:`RetryPolicy`
(``mxnet_tpu/resilience.py:89``) is the kv client's backoff: the same
delay sequence as the reference's for the same seed.
"""
from __future__ import annotations

import contextlib
import os
import random
import signal
import tempfile
import threading
import time

from . import config
from . import iowatch

__all__ = ['RetryPolicy', 'atomic_replace', 'faults_on', 'fault_point', 'set_faults',
           'clear_faults', 'FaultPlan', 'InjectedFault', 'InjectedDeath',
           'on_kill']


class RetryPolicy(object):
    """Exponential backoff with jitter and a per-op deadline
    (``mxnet_tpu/resilience.py:89``).

    ``delay(attempt)`` for attempt 0, 1, 2, ... is
    ``min(base * multiplier**attempt, max_delay)`` scaled by a uniform
    jitter factor in ``[1, 1+jitter]``, drawn from a ``random.Random``
    of ``seed``: the reference's sequence for the same seed."""

    __slots__ = ('base', 'multiplier', 'max_delay', 'jitter',
                 'deadline', 'max_retries', '_rng')

    def __init__(self, base=0.05, multiplier=2.0, max_delay=2.0,
                 jitter=0.25, deadline=120.0, max_retries=None, seed=None):
        assert base >= 0 and multiplier >= 1.0 and max_delay >= base
        assert jitter >= 0
        self.base = float(base)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = float(deadline)
        self.max_retries = max_retries
        self._rng = random.Random(seed)

    @classmethod
    def from_env(cls, seed=None):
        """From the ``MXTPU_KV_RETRY_*`` / ``MXTPU_KV_OP_DEADLINE``
        knobs."""
        return cls(base=config.get('MXTPU_KV_RETRY_BASE'),
                   max_delay=config.get('MXTPU_KV_RETRY_MAX'),
                   jitter=config.get('MXTPU_KV_RETRY_JITTER'),
                   deadline=config.get('MXTPU_KV_OP_DEADLINE'),
                   seed=seed)

    def delay(self, attempt):
        """Backoff before retry number ``attempt`` (0-based)."""
        d = min(self.base * (self.multiplier ** attempt), self.max_delay)
        if self.jitter:
            d *= 1.0 + self._rng.uniform(0.0, self.jitter)
        return d

    def run(self, fn, retry_on=(OSError,), deadline=None, on_retry=None):
        """Call ``fn`` until it returns, raising when the attempt budget
        or the wall-clock deadline (seconds, default ``self.deadline``)
        would be exceeded by the next backoff sleep.  ``on_retry(attempt,
        exc)`` observes each retry."""
        t_end = time.monotonic() + (self.deadline if deadline is None
                                    else deadline)
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                if (self.max_retries is not None
                        and attempt >= self.max_retries):
                    raise
                d = self.delay(attempt)
                if time.monotonic() + d >= t_end:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                # a backoff sleep on the fit thread is recovery badput
                with iowatch.account('recovery'):
                    time.sleep(d)
                attempt += 1


def _process_umask():
    mask = os.umask(0)
    os.umask(mask)
    return mask


@contextlib.contextmanager
def atomic_replace(path):
    """Yield a temp path in ``path``'s directory; on a clean exit fsync
    it, ``os.replace`` it over ``path`` and fsync the directory.  The
    file either commits whole or the previous one survives: an error (or
    a kill) inside the block leaves ``path`` as it was and removes the
    temp file where it can.  The target keeps its mode (or the umask's
    default)."""
    if path.startswith('file://'):
        path = path[len('file://'):]
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + '.tmp.')
    os.close(fd)
    try:
        mode = os.stat(path).st_mode & 0o7777
    except OSError:
        mode = 0o666 & ~_process_umask()
    try:
        os.chmod(tmp, mode)
    except OSError:
        pass
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

class InjectedFault(ConnectionResetError):
    """A connection failure made by the fault plan (a subclass of the
    real error, so recovery paths cannot tell it apart)."""


class InjectedDeath(RuntimeError):
    """A ``kill`` directive fired at a ``thread_kill=True`` site: the
    calling worker (a serving replica's coalescing thread) dies of it,
    the process survives, and the supervisor replaces the worker."""


class _Directive(object):
    __slots__ = ('site', 'action', 'prob', 'arg', 'arg2', 'count',
                 'fired')

    def __init__(self, site, action, prob, arg, arg2=None):
        self.site = site
        self.action = action      # drop | delay | wedge | sever | kill | after
        self.prob = prob          # probability, or N for 'after'
        self.arg = arg            # seconds, or the after-sub-action
        self.arg2 = arg2          # after:N:wedge's seconds
        self.count = 0            # matching events seen (for 'after')
        self.fired = False


class FaultPlan(object):
    """A parsed ``MXTPU_FAULTS`` spec: one seeded RNG, all state under a
    lock (determinism, not contention, is what matters here)."""

    def __init__(self, spec, seed=0):
        self.spec = spec
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._directives = []
        for tok in spec.split(';'):
            tok = tok.strip()
            if not tok:
                continue
            parts = tok.split(':')
            if len(parts) < 2:
                raise ValueError('bad MXTPU_FAULTS directive %r '
                                 '(want site:action[:arg])' % tok)
            site, action = parts[0], parts[1]
            if action == 'after':
                if len(parts) == 5 and parts[3] == 'wedge':
                    self._directives.append(
                        _Directive(site, 'after', float(parts[2]),
                                   'wedge', float(parts[4])))
                    continue
                if len(parts) != 4 or parts[3] not in ('drop', 'sever',
                                                       'kill'):
                    raise ValueError(
                        'bad after-directive %r (want site:after:N:'
                        'drop|sever|kill or site:after:N:wedge:SECS)'
                        % tok)
                self._directives.append(
                    _Directive(site, 'after', float(parts[2]), parts[3]))
            elif action in ('drop', 'sever', 'kill'):
                prob = float(parts[2]) if len(parts) > 2 else 1.0
                self._directives.append(_Directive(site, action, prob, None))
            elif action in ('delay', 'wedge'):
                if len(parts) < 4:
                    raise ValueError('bad %s-directive %r '
                                     '(want site:%s:P:SECS)'
                                     % (action, tok, action))
                self._directives.append(
                    _Directive(site, action, float(parts[2]),
                               float(parts[3])))
            else:
                raise ValueError('unknown fault action %r in %r'
                                 % (action, tok))

    def fire(self, point, thread_kill=False):
        """Evaluate every directive whose site prefixes ``point``.
        Returns 'drop' when the caller should discard its frame; may
        sleep, raise :class:`InjectedFault` or :class:`InjectedDeath`, or
        SIGKILL the process.  Actions are decided under the lock and
        carried out outside it, so one thread's wedge does not hold
        every other thread's fault points."""
        result = None
        delays = []
        hard = None            # 'sever' | 'kill'
        with self._lock:
            for d in self._directives:
                if not point.startswith(d.site):
                    continue
                if d.action == 'after':
                    d.count += 1
                    if d.fired or d.count != int(d.prob):
                        continue
                    d.fired = True
                    act = d.arg
                elif self._rng.random() < d.prob:
                    act = d.action
                else:
                    continue
                if act == 'drop':
                    result = 'drop'
                elif act in ('delay', 'wedge'):
                    delays.append(d.arg if d.action != 'after'
                                  else d.arg2)
                else:
                    hard = act
        for seconds in delays:
            time.sleep(seconds)
        if hard == 'sever':
            raise InjectedFault('injected fault: sever at %s' % point)
        if hard == 'kill' and thread_kill:
            raise InjectedDeath('injected fault: worker kill at %s'
                                % point)
        if hard == 'kill':
            for fn in list(_kill_hooks):
                try:
                    fn()
                except Exception:      # noqa: BLE001 - last breath
                    pass
            os.kill(os.getpid(), signal.SIGKILL)
        return result


_plan = None          # the armed FaultPlan, or None (the common case)
_kill_hooks = []      # run just before an injected SIGKILL


def on_kill(fn):
    """Run ``fn`` just before an injected ``kill`` SIGKILLs the process
    (idempotent; best effort, and fast)."""
    if fn not in _kill_hooks:
        _kill_hooks.append(fn)


def faults_on():
    """The hot paths' single check."""
    return _plan is not None


def fault_point(site, op=None, thread_kill=False):
    """Fire the armed plan at ``site`` (``site.op`` with ``op``); with no
    plan armed, returns None at once."""
    plan = _plan
    if plan is None:
        return None
    return plan.fire(site if op is None else '%s.%s' % (site, op),
                     thread_kill=thread_kill)


def set_faults(spec, seed=None):
    """Arm a plan (or, with a falsy spec, disarm); arming and disarming
    an armed plan are ``faults`` decision events."""
    global _plan
    from . import instrument
    if not spec:
        if _plan is not None:
            _plan = None
            instrument.decision('faults', 'clear',
                                reason='fault plan disarmed')
        return None
    _plan = FaultPlan(spec, seed=config.get('MXTPU_FAULTS_SEED')
                      if seed is None else seed)
    instrument.decision('faults', 'arm', severity='warn',
                        reason='fault plan armed: %s' % (spec,),
                        spec=str(spec))
    return _plan


def clear_faults():
    set_faults(None)


set_faults(config.get('MXTPU_FAULTS'))
