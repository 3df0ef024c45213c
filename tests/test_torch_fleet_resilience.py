"""The serving fleet's failure semantics, scenario against scenario:
request deadlines, replay-once, supervision (wedge and death quarantine,
a replacement warmed before the tear-down, its grace window), bounded
drains, the SIGTERM drain and the fault grammar, run through
``mxnet_tpu.serving`` and ``mxnet_tpu_torch.serving`` on the CPU.  Each
scenario's observable outcome (typed errors, counters, supervisor
events, replica counts, responses) must be the same in both packages.

The cases follow the reference's own
(``tests/test_serving_resilience.py``), without brownout and
postmortems, which wait for the autoscaler and the observability
planes.  Wedges are stubs held on a ``threading.Event`` with a 0 ms
wedge threshold, and supervision ticks are driven by hand, so no case
depends on a sleep; every ``result()``, ``join()`` and ``wait()`` takes
a timeout.
"""
import concurrent.futures
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import config as j_config
from mxnet_tpu import health as j_health
from mxnet_tpu import instrument as j_instrument
from mxnet_tpu import resilience as j_resilience
from mxnet_tpu import serving as j_serving
from mxnet_tpu_torch import config as t_config
from mxnet_tpu_torch import instrument as t_instrument
from mxnet_tpu_torch import resilience as t_resilience
from mxnet_tpu_torch import serving as t_serving

JAX = SimpleNamespace(name='jax', serving=j_serving, config=j_config,
                      instrument=j_instrument, resilience=j_resilience,
                      server_kw={})
TORCH = SimpleNamespace(name='torch', serving=t_serving, config=t_config,
                        instrument=t_instrument, resilience=t_resilience,
                        server_kw={'dev_type': 'cpu'})
WAIT = 30            # seconds: the bound on every wait in this file
SHAPES = {'data': (8, 6)}
X = np.zeros((1, 6), np.float32)


@pytest.fixture(autouse=True)
def _metrics_on():
    was = [(p, p.instrument.metrics_enabled()) for p in (JAX, TORCH)]
    for p, _ in was:
        p.instrument.reset_metrics()
        p.instrument.set_metrics(True)
        p.resilience.clear_faults()
    yield
    for p, on in was:
        p.resilience.clear_faults()
        p.instrument.set_metrics(on)
        p.instrument.reset_metrics()
    j_health._recorder = None


def _both(scenario):
    """Run ``scenario(pkg)`` on each package; the outcomes must be
    equal.  Returns the port's."""
    got = {p.name: scenario(p) for p in (JAX, TORCH)}
    assert got['torch'] == got['jax']
    return got['torch']


class _Stub(object):
    """Predictor-shaped replica: ``out = 2 * data[:, :1]``.  With
    ``gate`` set, a forward waits on it (bounded) after announcing itself
    on ``entered``."""

    def __init__(self):
        self._input_shapes = dict(SHAPES)
        self._batch_inputs = {'data'}
        self.num_outputs = 1
        self.gate = None
        self.entered = threading.Event()
        self.calls = 0
        self._out = None

    def forward(self, **kw):
        self.calls += 1
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=WAIT)
        self._out = 2.0 * np.asarray(kw['data'], np.float32)[:, :1]

    def get_output(self, i):
        return self._out


def _stub_server(pkg, n=1, **kw):
    """A server over stubs, with builder spares for EVERY slot: a
    quarantine frees slots, so a replacement can land anywhere."""
    stubs = [_Stub() for _ in range(8)]
    server = pkg.serving.ModelServer(**pkg.server_kw, **kw)
    server.load_model('s', predictor=stubs[0], input_shapes=dict(SHAPES),
                      warm_start=False)

    def build(slot=0, **bkw):
        return stubs[slot]
    server._build_predictor = build
    for _ in range(1, n):
        server.scale_up('s')
    return server, stubs


def _hold(stub):
    """Gate ``stub`` from now on (after its warm-up); returns the gate."""
    stub.gate = threading.Event()
    stub.entered.clear()
    return stub.gate


def _outcome(fut):
    try:
        return fut.result(timeout=WAIT)[0].ravel().tolist()
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__


def _events(evs, keys=('action', 'replica', 'why', 'inflight', 'replayed',
                       'failed', 'replacement', 'replicas')):
    return [{k: e[k] for k in keys if k in e} for e in evs]


def _count(pkg, name):
    return pkg.instrument.counter_value(name)


# ---------------------------------------------------------------------------
# Request deadlines
# ---------------------------------------------------------------------------

def _deadline(pkg):
    server, stubs = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        server.pause('s')
        # a deadline that has passed by the time the worker coalesces
        dead = server.submit('s', deadline_ms=1e-3, data=X + 1)
        live = server.submit('s', data=X + 2)      # no deadline
        time.sleep(0.002)
        calls0 = stubs[0].calls
        server.resume('s')
        out = {'dead': _outcome(dead), 'live': _outcome(live),
               'executed': stubs[0].calls - calls0}
        snap = pkg.instrument.metrics_snapshot()
        out['counters'] = {k: v for k, v in snap['counters'].items()
                           if k.startswith('serving.deadline_drops')}
        # exempt from the SLO series: only the live request is in it
        out['e2e_count'] = snap['histograms']['serving.e2e_secs']['count']
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_deadline_drop_is_typed_counted_exempt_and_never_executes():
    out = _both(_deadline)
    assert out == {'dead': 'DeadlineExceededError', 'live': [4.0],
                   'executed': 1,
                   'counters': {'serving.deadline_drops': 1,
                                'serving.deadline_drops|model=s,lane=batch':
                                    1},
                   'e2e_count': 1}


def _deadline_env(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        batcher = server._entry('s').batcher
        server.pause('s')
        fut = server.submit('s', data=X)              # the env default
        nodl = server.submit('s', deadline_ms=0, data=X)   # 0: none
        time.sleep(0.002)
        server.resume('s')
        return {'default': batcher.default_deadline_ms,
                'fut': _outcome(fut), 'nodl': _outcome(nodl)}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_deadline_default_comes_from_env(monkeypatch):
    monkeypatch.setenv('MXTPU_SERVE_DEADLINE_MS', '0.001')
    assert _both(_deadline_env) == {'default': 0.001,
                                    'fut': 'DeadlineExceededError',
                                    'nodl': [0.0]}


# ---------------------------------------------------------------------------
# Replay-once
# ---------------------------------------------------------------------------

def _requeue(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        batcher = server._entry('s').batcher
        server.pause('s')
        f1 = server.submit('s', data=X)
        f2 = server.submit('s', priority='interactive', data=X)
        with batcher._cond:
            batch = [batcher._queue.popleft(), batcher._hi.popleft()]
        err = pkg.serving.ReplicaQuarantinedError('quarantined twice')
        out = {'first': batcher.requeue_head(batch, err),
               'replayed': [r.replayed for r in batch],
               'heads': [batcher._queue[0] is batch[0],
                         batcher._hi[0] is batch[1]]}
        with batcher._cond:
            batch = [batcher._queue.popleft(), batcher._hi.popleft()]
        out['second'] = batcher.requeue_head(batch, err)
        out['futures'] = [_outcome(f) for f in (f1, f2)]
        out['counters'] = (_count(pkg, 'serving.replays'),
                           _count(pkg, 'serving.replays|model=s'))
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_requeue_head_replays_once_then_fails_typed():
    assert _both(_requeue) == {
        'first': (2, 0), 'replayed': [True, True], 'heads': [True, True],
        'second': (0, 2),
        'futures': ['ReplicaQuarantinedError'] * 2, 'counters': (2, 2)}


# ---------------------------------------------------------------------------
# Supervision
# ---------------------------------------------------------------------------

def _wedge_r0(server, stubs):
    """Replica 0 holds a flush (its stub gated) while replica 1 serves
    its own and goes idle again; returns (gate, futures)."""
    gate, gate1 = _hold(stubs[0]), _hold(stubs[1])
    server.pause('s')
    futs = [server.submit('s', data=X + v) for v in (1.0, 2.0)]
    server.resume('s')
    assert stubs[0].entered.wait(WAIT) and stubs[1].entered.wait(WAIT)
    gate1.set()
    done, _ = concurrent.futures.wait(
        futs, timeout=WAIT, return_when=concurrent.futures.FIRST_COMPLETED)
    assert done
    return gate, futs


def _wedged(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gate = None
    try:
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        gate, futs = _wedge_r0(server, stubs)
        evs = sup.tick()
        out = {'events': _events(evs),
               'reason': [e['reason'].split(' for ')[0] for e in evs
                          if e['action'] == 'quarantine'],
               'responses': sorted(_outcome(f) for f in futs),
               'replicas': server.replica_count('s'),
               'state': sup.state('s')}
        gauges = pkg.instrument.metrics_snapshot()['gauges']
        out['recovery_gauge'] = \
            'serving.replica_recovery_secs|model=s' in gauges
        # the released wedged worker finds its flush seized: it delivers
        # nothing and exits
        gate.set()
        zombie = server._entry('s').batcher._zombies[0]
        zombie.join(timeout=WAIT)
        out['zombie_alive'] = zombie.is_alive()
        out['counters'] = {k: _count(pkg, k) for k in (
            'serving.quarantines', 'serving.quarantines|model=s',
            'serving.replays', 'serving.abandoned_flushes',
            'serving.supervise.quarantine', 'serving.supervise.replace')}
        out['decisions'] = [e['action'] for e in
                            pkg.instrument.recent_decisions(
                                subsystem='supervisor')][-3:]
        return out
    finally:
        if gate is not None:
            gate.set()
        server.close(drain=False, timeout=WAIT)


def test_wedged_replica_is_quarantined_replayed_and_replaced():
    out = _both(_wedged)
    assert out['events'] == [
        {'action': 'quarantine', 'replica': 0, 'why': 'wedged',
         'inflight': 1},
        {'action': 'replay', 'replica': 0, 'replayed': 1, 'failed': 0},
        {'action': 'replace', 'replica': 0, 'replacement': 2,
         'replicas': 2}]
    assert out['reason'] == ['no flush progress']
    # every future resolves, the seized one through its replay
    assert out['responses'] == [[2.0], [4.0]]
    assert out['replicas'] == 2 and out['recovery_gauge']
    assert out['state'] == {0: 'quarantined', 1: 'healthy',
                            2: 'replacing'}
    assert not out['zombie_alive']
    assert out['counters'] == {
        'serving.quarantines': 1, 'serving.quarantines|model=s': 1,
        'serving.replays': 1, 'serving.abandoned_flushes': 1,
        'serving.supervise.quarantine': 1, 'serving.supervise.replace': 1}
    assert out['decisions'] == ['quarantine', 'replay', 'replace']


def _kill_worker(pkg, server, rid):
    """Kill replica ``rid``'s worker at its next loop pass (the
    ``serve.worker`` thread_kill site) and wait for it to die."""
    batcher = server._entry('s').batcher
    pkg.resilience.set_faults('serve.worker.r%d:after:1:kill' % rid)
    server.predict('s', data=X, timeout=WAIT)    # served; then it dies
    t = batcher._workers[rid]
    t.join(timeout=WAIT)
    assert not t.is_alive()
    return batcher.dead_workers()


def _dead(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        sup = server.supervise('s', wedge_ms=5000, interval_s=0,
                               start=False)
        dead = _kill_worker(pkg, server, 0)
        out = {'dead': {k: type(v).__name__ for k, v in dead.items()}}
        queued = server.submit('s', data=X + 1)      # waits for the repair
        out['events'] = _events(sup.tick())
        out['replicas'] = server.replica_count('s')
        out['queued'] = _outcome(queued)
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_dead_worker_is_quarantined_and_replaced():
    assert _both(_dead) == {
        'dead': {0: 'InjectedDeath'},
        'events': [{'action': 'quarantine', 'replica': 0, 'why': 'dead',
                    'inflight': 0},
                   {'action': 'replace', 'replica': 0, 'replacement': 1,
                    'replicas': 1}],
        'replicas': 1, 'queued': [2.0]}


def _dies_in_grace(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        sup = server.supervise('s', wedge_ms=5000, interval_s=0,
                               start=False)
        rounds = []
        for _ in range(2):
            rid = server._entry('s').replicas[0].rid
            _kill_worker(pkg, server, rid)
            rounds.append(_events(sup.tick()))
        # the second kill hit the REPLACEMENT inside its grace window:
        # 'replacing' does not shield it from supervision
        return {'rounds': rounds,
                'quarantines': _count(pkg, 'serving.quarantines'),
                'replicas': server.replica_count('s'),
                'serves': server.predict('s', data=X + 3,
                                         timeout=WAIT)[0].tolist()}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_replacement_dying_in_grace_is_requarantined():
    out = _both(_dies_in_grace)
    assert [[e['action'] for e in r] for r in out['rounds']] == \
        [['quarantine', 'replace']] * 2
    assert out['quarantines'] == 2 and out['replicas'] == 1
    assert out['serves'] == [[6.0]]


def _warmup_under_admin_lock(pkg):
    server, stubs = _stub_server(pkg, n=1, max_delay_ms=0)
    gate = _hold(stubs[0])
    try:
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        entry = server._entry('s')
        orig_build = server._build_predictor
        lock_free = []

        def probing_build(slot=0, **kw):
            # a scale decision from another thread must be locked out
            # for the whole replacement build (the admin RLock is
            # re-entrant on this one)
            got = []

            def probe():
                ok = entry.admin_lock.acquire(blocking=False)
                if ok:
                    entry.admin_lock.release()
                got.append(ok)
            t = threading.Thread(target=probe)
            t.start()
            t.join(timeout=WAIT)
            lock_free.append(got[0])
            return orig_build(slot=slot, **kw)
        server._build_predictor = probing_build
        fut = server.submit('s', data=X + 1)
        assert stubs[0].entered.wait(WAIT)
        actions = [e['action'] for e in sup.tick()]
        return {'actions': actions, 'lock_free': lock_free,
                'response': _outcome(fut)}
    finally:
        gate.set()
        server.close(drain=False, timeout=WAIT)


def test_replacement_warmup_holds_admin_lock_against_scale_decisions():
    assert _both(_warmup_under_admin_lock) == {
        'actions': ['quarantine', 'replay', 'replace'],
        'lock_free': [False], 'response': [2.0]}


def _protected(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gate = None
    try:
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        gate, futs = _wedge_r0(server, stubs)
        new_rid = [e for e in sup.tick()
                   if e['action'] == 'replace'][0]['replacement']
        out = {'responses': sorted(_outcome(f) for f in futs),
               'protected': sorted(sup.protected('s')),
               'rids': [r.rid for r in server._entry('s').replicas]}
        # the untouched replica goes, never the protected replacement
        out['scale_down'] = server.scale_down('s')
        out['left'] = [r.rid for r in server._entry('s').replicas]
        with sup._lock:
            w = sup._watches['s']
            for rid in list(w.protected):
                w.protected[rid] = time.monotonic() - 1   # grace over
        out['after_grace'] = (sorted(sup.protected('s')),
                              sup.state('s').get(new_rid))
        return out
    finally:
        if gate is not None:
            gate.set()
        server.close(drain=False, timeout=WAIT)


def test_scale_down_never_picks_the_protected_replacement():
    assert _both(_protected) == {
        'responses': [[2.0], [4.0]], 'protected': [2], 'rids': [1, 2],
        'scale_down': 1, 'left': [2], 'after_grace': ([], 'healthy')}


def _supervise_off(pkg):
    before = {t.name for t in threading.enumerate()}
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        server.predict('s', data=X, timeout=WAIT)
        new = {t.name for t in threading.enumerate()} - before
        batcher = server._entry('s').batcher
        return {'knob': pkg.config.get('MXTPU_SERVE_SUPERVISE'),
                'supervisor_threads': [n for n in new
                                       if 'supervisor' in n],
                'supervisor': server.supervisor,
                'faults_on': pkg.resilience.faults_on(),
                'deadline': batcher.default_deadline_ms}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_supervise_off_spawns_no_threads():
    assert _both(_supervise_off) == {
        'knob': False, 'supervisor_threads': [], 'supervisor': None,
        'faults_on': False, 'deadline': 0.0}


def test_supervise_on_runs_one_poll_thread_until_close():
    server, _ = _stub_server(TORCH, n=1)
    sup = server.supervise('s', interval_s=0.05)
    assert sup._thread.is_alive()
    assert server.supervise('s') is sup     # one per server
    server.close(drain=False, timeout=WAIT)
    assert not sup._thread and not any(
        t.name == 'mxtpu-torch-serve-supervisor' and t.is_alive()
        for t in threading.enumerate())


# ---------------------------------------------------------------------------
# Bounded drains
# ---------------------------------------------------------------------------

def _bounded_unload(pkg, timeout=0.3):
    server, stubs = _stub_server(pkg, n=1, max_delay_ms=0)
    gate = _hold(stubs[0])
    try:
        inflight = server.submit('s', data=X)
        assert stubs[0].entered.wait(WAIT)
        queued = server.submit('s', data=X)
        t0 = time.monotonic()
        server.unload_model('s', drain=True, timeout=timeout)
        return {'bounded': time.monotonic() - t0 < 5.0,
                'inflight': _outcome(inflight),
                'queued': _outcome(queued)}
    finally:
        gate.set()


def test_unload_drain_with_wedged_replica_is_bounded_and_typed():
    assert _both(_bounded_unload) == {
        'bounded': True, 'inflight': 'ReplicaQuarantinedError',
        'queued': 'ServerOverloadedError'}


def test_drain_timeout_default_comes_from_env(monkeypatch):
    monkeypatch.setenv('MXTPU_SERVE_DRAIN_TIMEOUT', '0.2')
    assert _both(lambda p: _bounded_unload(p, timeout=None)) == {
        'bounded': True, 'inflight': 'ReplicaQuarantinedError',
        'queued': 'ServerOverloadedError'}


def _drain(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    sup = server.supervise('s', wedge_ms=5000, interval_s=0, start=False)
    for _ in range(3):
        server.predict('s', data=X, timeout=WAIT)
    snap = server.drain(timeout=5.0, reason='test')
    out = {'keys': sorted(set(snap) - {'servewatch'}),
           'reason': snap['reason'], 'models': snap['models'],
           'bounded': snap['drain_secs'] < 5.0,
           'requests': snap['stats']['counters']['serving.requests'],
           'events': (snap['autoscaler_events'],
                      snap['supervisor_events']),
           'flight_path': snap['flight_path'],
           'drains': _count(pkg, 'serving.drains'),
           'same_supervisor': sup is not None}
    try:
        server.predict('s', data=X, timeout=WAIT)
        out['after'] = 'served'
    except Exception as e:                 # noqa: BLE001 - the outcome
        out['after'] = type(e).__name__
    return out


def test_server_drain_returns_the_snapshot():
    out = _both(_drain)
    assert out['keys'] == ['autoscaler_events', 'drain_secs', 'flight_path',
                           'models', 'reason', 'stats', 'supervisor_events']
    assert out['requests'] == 3 and out['drains'] == 1
    assert out['flight_path'] is None and out['after'] == \
        'ModelNotFoundError'


def _sigterm(pkg):
    prev_called = []
    old = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM,
                  lambda sig, frm: prev_called.append(sig))
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0)
    try:
        out = {'installed': server.install_sigterm_drain(timeout=5.0)}
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        out['chained'] = prev_called == [signal.SIGTERM]
        out['drains'] = _count(pkg, 'serving.drains')
        res = []
        t = threading.Thread(
            target=lambda: res.append(server.install_sigterm_drain()))
        t.start()
        t.join(timeout=WAIT)
        out['off_main_thread'] = res
        return out
    finally:
        signal.signal(signal.SIGTERM, old)
        server.close(drain=False, timeout=WAIT)


def test_install_sigterm_drain_chains_previous_handler():
    assert _both(_sigterm) == {'installed': True, 'chained': True,
                               'drains': 1, 'off_main_thread': [False]}


# ---------------------------------------------------------------------------
# Fault grammar
# ---------------------------------------------------------------------------

def _grammar(pkg):
    res = pkg.resilience
    out = {}
    plan = res.FaultPlan('x:wedge:1:0.01', seed=0)
    t0 = time.monotonic()
    plan.fire('x.y')
    out['wedge'] = time.monotonic() - t0 >= 0.01
    plan = res.FaultPlan('x:after:2:wedge:0.01', seed=0)
    slept = []
    for _ in range(3):
        t0 = time.monotonic()
        plan.fire('x')
        slept.append(time.monotonic() - t0 >= 0.01)
    out['after_wedge'] = slept             # the 2nd only, once
    out['drops'] = [res.FaultPlan('a.b:drop', seed=0).fire('a.b.c'),
                    res.FaultPlan('a.b:drop', seed=0).fire('a.c')]
    plan = res.FaultPlan('s:after:2:sever', seed=0)
    out['sever'] = [_fires(plan.fire, 's') for _ in range(3)]
    flips = res.FaultPlan('p:drop:0.5', seed=7)
    out['seeded'] = [flips.fire('p') for _ in range(8)]
    out['bad'] = [_fires(res.FaultPlan, spec) for spec in (
        'x:wedge:1', 'x:after:1:wedge', 'x', 'x:explode',
        'x:after:1:boom')]
    return out


def _fires(fn, *a, **kw):
    try:
        fn(*a, **kw)
        return None
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__


def test_fault_grammar_wedge_after_and_seeded_flips():
    out = _both(_grammar)
    assert out['wedge'] and out['after_wedge'] == [False, True, False]
    assert out['drops'] == ['drop', None]
    assert out['sever'] == [None, 'InjectedFault', None]
    assert out['bad'] == ['ValueError'] * 5


def _thread_kill(pkg):
    res = pkg.resilience
    out = {'plan': _fires(res.FaultPlan('w:kill', seed=0).fire, 'w.r0',
                          thread_kill=True)}
    res.set_faults('serve.worker.r3:kill')
    out['armed'] = res.faults_on()
    out['site'] = _fires(res.fault_point, 'serve.worker', op='r3',
                         thread_kill=True)
    out['other'] = res.fault_point('serve.worker', op='r1',
                                   thread_kill=True)
    res.clear_faults()
    out['cleared'] = res.faults_on()
    out['decisions'] = [e['action'] for e in pkg.instrument.recent_decisions(
        subsystem='faults')][-2:]
    return out


def test_kill_at_thread_kill_site_raises_injected_death():
    assert _both(_thread_kill) == {
        'plan': 'InjectedDeath', 'armed': True, 'site': 'InjectedDeath',
        'other': None, 'cleared': False, 'decisions': ['arm', 'clear']}
