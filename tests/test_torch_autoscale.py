"""The serving fleet's control plane, scenario against scenario: the
replica autoscaler (windowed p99, scale up/down, shrink/restore, the
brownout ladder in both directions) and the windowed histogram reads it
steers on, run through ``mxnet_tpu.serving`` and
``mxnet_tpu_torch.serving`` on the CPU.  The same scripted traffic and
the same hand-driven ``tick()`` calls (``async_actuation = False``,
``start=False``) must give the same decision sequence (action, level,
replicas, max_batch), the same counters and the same typed errors in
both packages.

The cases follow the reference's own (``tests/test_serving_fleet.py``
windowed reads and autoscaler cases, ``tests/test_serving_resilience.py``
supervision x autoscaler contracts and the brownout ladder).  Latency is
made, not waited for: a breaching window is stubs that sleep 20 ms
against a 5 ms SLO, a clear one is instant stubs against a 1 s SLO, and
quarantines are stubs held on a ``threading.Event`` with a 0 ms wedge
threshold.  One port-only case holds every replica built while the
batch is shrunk (a supervisor replacement, a reload, a scale-up) to the
CONFIGURED cap.  ``HysteresisGate`` and ``SeriesDetector`` give the same
verdicts on the same observation sequences in both packages.  Every
``result()``, ``join()`` and ``wait()`` takes a timeout.
"""
import concurrent.futures
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import detector as j_detector
from mxnet_tpu import instrument as j_instrument
from mxnet_tpu import resilience as j_resilience
from mxnet_tpu import serving as j_serving
from mxnet_tpu_torch import detector as t_detector
from mxnet_tpu_torch import instrument as t_instrument
from mxnet_tpu_torch import resilience as t_resilience
from mxnet_tpu_torch import serving as t_serving

JAX = SimpleNamespace(name='jax', serving=j_serving, detector=j_detector,
                      instrument=j_instrument, resilience=j_resilience,
                      server_kw={})
TORCH = SimpleNamespace(name='torch', serving=t_serving,
                        detector=t_detector, instrument=t_instrument,
                        resilience=t_resilience,
                        server_kw={'dev_type': 'cpu'})
WAIT = 30            # seconds: the bound on every wait in this file
SHAPES = {'data': (8, 6)}
X = np.zeros((1, 6), np.float32)
SLOW_S = 0.02        # a breaching stub's service time, against a 5 ms SLO


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


def _both(scenario):
    """Run ``scenario(pkg)`` on each package; the outcomes must be
    equal.  Returns the port's."""
    got = {p.name: scenario(p) for p in (JAX, TORCH)}
    assert got['torch'] == got['jax']
    return got['torch']


class _Stub(object):
    """Predictor-shaped replica: ``out = 2 * data[:, :1]`` after
    ``service_s`` of (GIL-released) sleep.  With ``gate`` set, a forward
    waits on it (bounded) after announcing itself on ``entered``."""

    def __init__(self, service_s=0.0):
        self._input_shapes = dict(SHAPES)
        self._batch_inputs = {'data'}
        self.num_outputs = 1
        self.service_s = service_s
        self.gate = None
        self.entered = threading.Event()
        self._out = None

    def forward(self, **kw):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=WAIT)
        if self.service_s:
            time.sleep(self.service_s)
        self._out = 2.0 * np.asarray(kw['data'], np.float32)[:, :1]

    def get_output(self, i):
        return self._out


def _stub_server(pkg, n=1, service_s=0.0, stubs=None, **kw):
    """A server over stubs, with builder spares for EVERY slot (a
    quarantine frees slots, so a replacement can land anywhere)."""
    stubs = stubs or [_Stub(service_s) for _ in range(8)]
    server = pkg.serving.ModelServer(**pkg.server_kw, **kw)
    server.load_model('s', predictor=stubs[0], input_shapes=dict(SHAPES),
                      warm_start=False)

    def build(slot=0, **bkw):
        return stubs[slot]
    server._build_predictor = build
    for _ in range(1, n):
        server.scale_up('s')
    return server, stubs


def _watch(server, **kw):
    """Enroll 's' for hand-driven ticks with synchronous actuation."""
    opts = dict(slo_p99_ms=5.0, interval_s=0, cooldown_s=0, start=False)
    opts.update(kw)
    sc = server.autoscale('s', **opts)
    sc.async_actuation = False
    return sc


def _decisions(evs):
    return [{k: e[k] for k in ('action', 'replicas', 'max_batch', 'level')
             if k in e} for e in evs]


def _autoscale_counters(pkg):
    snap = pkg.instrument.metrics_snapshot()['counters']
    return {k: v for k, v in snap.items()
            if k.startswith(('serving.autoscale.', 'serving.brownout',
                             'serving.scale_'))}


def _outcome(call):
    try:
        return call()
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__


# ---------------------------------------------------------------------------
# Windowed reads
# ---------------------------------------------------------------------------

def _window_resurrection(pkg):
    ins = pkg.instrument
    name = 'serving.e2e_secs|lane=batch,model=wr,replica=1'
    ins.histogram(name).observe(0.01)
    win = ins.HistogramWindow()
    win.merged_delta_labeled('serving.e2e_secs|', model='wr')   # open
    ins.drop_labeled_metrics(model='wr', replica='1')
    out = [win.merged_delta_labeled('serving.e2e_secs|',
                                    model='wr')['count']]
    # the slot reused: a fresh series with FEWER counts than the stale
    # base must read whole, not clamped against the dead series
    for _ in range(3):
        ins.histogram(name).observe(0.02)
    out.append(win.merged_delta_labeled('serving.e2e_secs|',
                                        model='wr')['count'])
    win2 = ins.HistogramWindow()
    win2.delta(name)
    ins.drop_labeled_metrics(model='wr', replica='1')
    out.append(win2.delta(name)['count'])
    ins.histogram(name).observe(0.03)
    out.append(win2.delta(name)['count'])
    return out


def test_histogram_window_does_not_resurrect_dropped_series():
    assert _both(_window_resurrection) == [0, 3, 0, 1]


def _window_reshape(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=1)
    ins = pkg.instrument
    try:
        for _ in range(6):
            server.predict('s', data=X, timeout=WAIT)
        win = ins.HistogramWindow()
        win.merged_delta_labeled('serving.e2e_secs|', model='s')
        out = {'scale_down': server.scale_down('s')}
        out['replica1_left'] = sorted(
            k for k in ins.metrics_snapshot().get('histograms', {})
            if (ins.split_labeled_name(k)[1] or {}).get('replica') == '1')
        for _ in range(4):
            server.predict('s', data=X, timeout=WAIT)
        out['after_scale_down'] = win.merged_delta_labeled(
            'serving.e2e_secs|', model='s')['count']
        server.reload_model('s', predictor=stubs[2])
        for _ in range(3):
            server.predict('s', data=X, timeout=WAIT)
        out['after_reload'] = win.merged_delta_labeled(
            'serving.e2e_secs|', model='s')['count']
        out['empty'] = win.merged_delta_labeled(
            'serving.e2e_secs|', model='s')['count']
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_windowed_reads_across_scale_down_and_reload_mid_window():
    assert _both(_window_reshape) == {
        'scale_down': 1, 'replica1_left': [], 'after_scale_down': 4,
        'after_reload': 3, 'empty': 0}


# ---------------------------------------------------------------------------
# The control law
# ---------------------------------------------------------------------------

def _scale_up(pkg):
    server, _ = _stub_server(pkg, n=1, service_s=SLOW_S, max_delay_ms=1,
                             max_batch=2)
    try:
        sc = _watch(server, up_after=2, min_samples=3, max_replicas=2)
        ticks = []
        for _ in range(2):                 # two breaching windows
            for _ in range(4):
                server.predict('s', data=X, timeout=WAIT)
            ticks.append(_decisions(sc.tick()))
        ev = [e for e in sc.events if e['action'] == 'scale_up'][0]
        return {'ticks': ticks, 'replicas': server.replica_count('s'),
                'keys': sorted(ev), 'over_slo': ev['p99_ms'] > 5.0,
                'counters': _autoscale_counters(pkg),
                'decisions': [e['action'] for e in
                              pkg.instrument.recent_decisions(
                                  subsystem='autoscaler')][-1:]}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_autoscaler_scales_up_on_breach_and_logs_every_decision():
    out = _both(_scale_up)
    assert out['ticks'] == [[], [{'action': 'scale_up', 'replicas': 2,
                                  'max_batch': 2}]]
    assert out['replicas'] == 2 and out['over_slo']
    assert out['keys'] == ['action', 'max_batch', 'model', 'p99_ms',
                           'queue_depth', 'reason', 'replicas',
                           'slo_p99_ms', 't']
    assert out['counters'] == {'serving.autoscale.decisions': 1,
                               'serving.autoscale.scale_up': 1,
                               'serving.scale_ups': 1}
    assert out['decisions'] == ['scale_up']


def _shrink_restore(pkg):
    server, stubs = _stub_server(pkg, n=1, service_s=SLOW_S,
                                 max_delay_ms=1, max_batch=8)
    try:
        sc = _watch(server, up_after=1, down_after=1, min_samples=3,
                    max_replicas=1, min_batch=2)
        batcher = server._entry('s').batcher
        for _ in range(4):
            server.predict('s', data=X, timeout=WAIT)
        ticks = [_decisions(sc.tick())]
        shrunk = batcher.max_batch
        stubs[0].service_s = 0.0
        sc._watches['s'].slo_p99_ms = 1000.0
        for _ in range(2):
            for _ in range(6):
                server.predict('s', data=X, timeout=WAIT)
            ticks.append(_decisions(sc.tick()))
        out = {'ticks': ticks, 'shrunk': shrunk,
               'restored': batcher.max_batch,
               'configured': batcher.configured_max_batch}
        # re-enrolling mid-shrink keeps the CONFIGURED restore target
        batcher.max_batch = 4
        sc.watch('s', slo_p99_ms=50.0, start=False)
        out['orig_after_rewatch'] = sc._watches['s'].orig_max_batch
        out['counters'] = _autoscale_counters(pkg)
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_autoscaler_shrinks_then_restores_max_batch():
    out = _both(_shrink_restore)
    assert out['ticks'] == [
        [{'action': 'shrink_batch', 'replicas': 1, 'max_batch': 4}],
        [{'action': 'restore_batch', 'replicas': 1, 'max_batch': 8}], []]
    assert (out['shrunk'], out['restored'], out['configured'],
            out['orig_after_rewatch']) == (4, 8, 8, 8)


def _unload_unwatches(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=1)
    try:
        sc = _watch(server)
        out = {'watched': sc.watched()}
        server.unload_model('s', drain=False)
        out['after_unload'] = sc.watched()
        sc.watch('s', slo_p99_ms=5.0, start=False)
        out['late_tick'] = _decisions(sc.tick())
        out['late_scale'] = (server.scale_up('s'), server.scale_down('s'))
        out['predict'] = _outcome(lambda: server.predict('s', data=X))
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_autoscaler_serializes_with_unload_and_unwatches():
    assert _both(_unload_unwatches) == {
        'watched': ['s'], 'after_unload': [],
        'late_tick': [{'action': 'unwatch', 'replicas': 0,
                       'max_batch': None}],
        'late_scale': (None, None), 'predict': 'ModelNotFoundError'}


def _scale_error(pkg):
    """A model loaded from a prebuilt predictor has no builder source:
    the autoscaler's scale_up is a logged refusal with the real error,
    never a replica that is not one."""
    server = pkg.serving.ModelServer(**pkg.server_kw, max_delay_ms=1)
    server.load_model('s', predictor=_Stub(), input_shapes=dict(SHAPES),
                      warm_start=False)
    try:
        out = {'direct': _outcome(lambda: server.scale_up('s'))}
        sc = _watch(server, slo_p99_ms=0.0001, up_after=1, min_samples=1)
        server.predict('s', data=X, timeout=WAIT)
        evs = sc.tick()
        out['tick'] = _decisions(evs)
        out['reason'] = evs[0]['reason'].split(':')[0]
        out['replicas'] = server.replica_count('s')
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_failed_scale_up_is_a_logged_refusal():
    assert _both(_scale_error) == {
        'direct': 'MXNetError',
        'tick': [{'action': 'refused', 'replicas': 1, 'max_batch': 64}],
        'reason': 'scale_up failed', 'replicas': 1}


def _thin_window(pkg):
    server, _ = _stub_server(pkg, n=1, service_s=SLOW_S, max_delay_ms=1)
    try:
        sc = _watch(server, slo_p99_ms=1.0, up_after=1, min_samples=10)
        server.predict('s', data=X, timeout=WAIT)      # 1 sample < 10
        gauges = pkg.instrument.metrics_snapshot()['gauges']
        return {'tick': sc.tick(), 'replicas': server.replica_count('s'),
                'p99_gauge': [k for k in gauges
                              if k.startswith('serving.autoscale.p99')],
                'last_p99': sc._watches['s'].last_p99_ms}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_autoscaler_thin_window_makes_no_decision():
    assert _both(_thin_window) == {'tick': [], 'replicas': 1,
                                   'p99_gauge': [], 'last_p99': None}


def _needs_metrics(pkg):
    server, _ = _stub_server(pkg, n=1)
    try:
        pkg.instrument.set_metrics(False)
        out = [_outcome(lambda: server.autoscale('s', slo_p99_ms=5.0,
                                                 start=False))]
        pkg.instrument.set_metrics(True)
        out.append(_outcome(lambda: server.autoscale('s', start=False)))
        out.append(_outcome(lambda: server.autoscale('none',
                                                     slo_p99_ms=5.0)))
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_autoscale_refuses_without_metrics_or_slo():
    assert _both(_needs_metrics) == ['MXNetError', 'MXNetError',
                                     'ModelNotFoundError']


# ---------------------------------------------------------------------------
# Supervision x autoscaler
# ---------------------------------------------------------------------------

def _hold(stub):
    stub.gate = threading.Event()
    stub.entered.clear()
    return stub.gate


def _wedge_r0(server, stubs):
    """Replica 0 holds a flush while replica 1 serves its own; returns
    (gate, futures)."""
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


def _quarantine_excluded(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gate = None
    try:
        sc = _watch(server, slo_p99_ms=50.0, up_after=1, min_samples=3,
                    max_replicas=2)
        w = sc._watches['s']
        # a corpse's latency on replica 0's labeled series
        for _ in range(6):
            pkg.instrument.observe_hist(
                'serving.e2e_secs|lane=batch,model=s,replica=0', 10.0)
        p99, samples, _ = sc._windowed(w)
        out = {'poisoned': (samples, p99 > 50.0)}
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        gate, futs = _wedge_r0(server, stubs)
        out['repair'] = [e['action'] for e in sup.tick()]
        out['responses'] = sorted(f.result(timeout=WAIT)[0].ravel()
                                  .tolist() for f in futs)
        sc._windowed(w)                       # prime
        for _ in range(6):
            server.predict('s', data=X, timeout=WAIT)
        p99, samples, _ = sc._windowed(w)
        out['after'] = (samples, p99 < 50.0)
        return out
    finally:
        if gate is not None:
            gate.set()
        server.close(drain=False, timeout=WAIT)


def test_quarantined_replica_excluded_from_windowed_p99():
    assert _both(_quarantine_excluded) == {
        'poisoned': (6, True), 'repair': ['quarantine', 'replay',
                                          'replace'],
        'responses': [[2.0], [4.0]], 'after': (6, True)}


def _tick_during_replacement(pkg):
    """An autoscaler decision taken while the supervisor builds a
    replacement waits on the admin lock until the repair is whole."""
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gate = None
    try:
        sc = _watch(server, slo_p99_ms=50.0, up_after=1, min_samples=3,
                    max_replicas=4)
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        orig_build = server._build_predictor
        seen = []

        def probing_build(slot=0, **kw):
            if not seen:
                # breach evidence on the healthy replica, then a tick
                # from another thread: its scale_up must block
                for _ in range(6):
                    pkg.instrument.observe_hist(
                        'serving.e2e_secs|lane=batch,model=s,replica=1',
                        10.0)
                t = threading.Thread(target=lambda: seen.append(
                    _decisions(sc.tick())))
                t.start()
                t.join(timeout=0.3)
                seen.append(('blocked', t.is_alive(), t))
            return orig_build(slot=slot, **kw)
        server._build_predictor = probing_build
        gate, futs = _wedge_r0(server, stubs)
        repair = [e['action'] for e in sup.tick()]
        t = seen[0][2]
        t.join(timeout=WAIT)
        gate.set()
        for f in futs:
            f.result(timeout=WAIT)
        return {'repair': repair, 'blocked': seen[0][1],
                'tick_done': not t.is_alive(), 'tick': seen[1],
                'replicas': server.replica_count('s')}
    finally:
        if gate is not None:
            gate.set()
        server.close(drain=False, timeout=WAIT)


def test_replacement_warmup_holds_admin_lock_against_scale_decisions():
    assert _both(_tick_during_replacement) == {
        'repair': ['quarantine', 'replay', 'replace'], 'blocked': True,
        'tick_done': True,
        'tick': [{'action': 'scale_up', 'replicas': 3, 'max_batch': 1}],
        'replicas': 3}


# ---------------------------------------------------------------------------
# Brownout
# ---------------------------------------------------------------------------

def _ladder(pkg):
    server, stubs = _stub_server(pkg, n=1, service_s=SLOW_S,
                                 max_delay_ms=1, max_batch=4)
    try:
        sc = _watch(server, up_after=1, down_after=1, min_samples=3,
                    max_replicas=1, min_batch=2, brownout=True)
        batcher = server._entry('s').batcher

        def traffic_tick():
            lane = 'interactive' if batcher.shed_batch else None
            for _ in range(4):
                server.predict('s', priority=lane, data=X, timeout=WAIT)
            return _decisions(sc.tick())

        out = {'up': [traffic_tick() for _ in range(4)],
               'at_top': (batcher.shed_batch, batcher.max_batch)}
        gauges = pkg.instrument.metrics_snapshot()['gauges']
        out['level_gauge'] = gauges.get('serving.brownout_level|model=s')
        out['batch_lane'] = _outcome(lambda: server.predict(
            's', data=X, timeout=WAIT))
        out['interactive'] = _outcome(lambda: server.predict(
            's', priority='interactive', data=X, timeout=WAIT)[0].tolist())
        counters = pkg.instrument.metrics_snapshot()['counters']
        out['sheds'] = {k: v for k, v in counters.items()
                        if k.startswith(('serving.brownout_sheds',
                                         'serving.shed_total'))}
        stubs[0].service_s = 0.0
        sc._watches['s'].slo_p99_ms = 1000.0
        out['down'] = [traffic_tick() for _ in range(3)]
        out['after'] = (batcher.shed_batch, batcher.max_batch)
        out['batch_lane_again'] = _outcome(lambda: server.predict(
            's', data=X, timeout=WAIT)[0].tolist())
        gauges = pkg.instrument.metrics_snapshot()['gauges']
        out['level_gauge_after'] = gauges.get(
            'serving.brownout_level|model=s')
        out['counters'] = _autoscale_counters(pkg)
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_brownout_ladder_escalates_and_deescalates_in_order():
    out = _both(_ladder)
    assert out['up'] == [
        [{'action': 'brownout', 'replicas': 1, 'max_batch': 4,
          'level': 1}],
        [{'action': 'brownout', 'replicas': 1, 'max_batch': 2,
          'level': 2}],
        [{'action': 'brownout', 'replicas': 1, 'max_batch': 2,
          'level': 3}],
        [{'action': 'refused', 'replicas': 1, 'max_batch': 2}]]
    assert out['at_top'] == (True, 2) and out['level_gauge'] == 3
    assert out['batch_lane'] == 'ServerOverloadedError'
    assert out['interactive'] == [[0.0]]
    # policy sheds stay out of the per-lane series the controller reads
    assert out['sheds'] == {'serving.shed_total': 1,
                            'serving.brownout_sheds': 1,
                            'serving.brownout_sheds|model=s': 1}
    assert out['down'] == [
        [{'action': 'restore_batch', 'replicas': 1, 'max_batch': 4}],
        [{'action': 'brownout', 'replicas': 1, 'max_batch': 4,
          'level': 0}], []]
    assert out['after'] == (False, 4) and out['level_gauge_after'] == 0
    assert out['batch_lane_again'] == [[0.0]]


def _brownout_off(pkg):
    server, _ = _stub_server(pkg, n=1, service_s=SLOW_S, max_delay_ms=1,
                             max_batch=4)
    try:
        sc = _watch(server, up_after=1, down_after=1, min_samples=3,
                    max_replicas=1, min_batch=2, brownout=False)
        ticks = []
        for _ in range(2):
            for _ in range(4):
                server.predict('s', data=X, timeout=WAIT)
            ticks.append(_decisions(sc.tick()))
        return {'ticks': ticks,
                'shed_batch': server._entry('s').batcher.shed_batch,
                'counters': _autoscale_counters(pkg)}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_brownout_off_keeps_the_shrink_then_refuse_path():
    out = _both(_brownout_off)
    assert out['ticks'] == [
        [{'action': 'shrink_batch', 'replicas': 1, 'max_batch': 2}],
        [{'action': 'refused', 'replicas': 1, 'max_batch': 2}]]
    assert not out['shed_batch']


def test_brownout_default_comes_from_env(monkeypatch):
    monkeypatch.setenv('MXTPU_SERVE_BROWNOUT', '1')
    monkeypatch.setenv('MXTPU_SERVE_MAX_REPLICAS', '3')

    def scenario(pkg):
        server, _ = _stub_server(pkg, n=1)
        try:
            w = _watch(server)._watches['s']
            return (w.brownout, w.max_replicas)
        finally:
            server.close(drain=False, timeout=WAIT)
    assert _both(scenario) == (True, 3)


# ---------------------------------------------------------------------------
# Port-only: replicas built while the batch is shrunk warm to the cap
# ---------------------------------------------------------------------------

class _WarmStub(_Stub):
    """A stub with ``warm_buckets``: records the cap each warm-up got."""

    def __init__(self):
        super().__init__()
        self.warmed = []

    def warm_buckets(self, max_batch):
        self.warmed.append(max_batch)
        return []


def test_replicas_built_while_shrunk_warm_to_the_configured_cap():
    stubs = [_WarmStub() for _ in range(8)]
    server, _ = _stub_server(TORCH, n=1, stubs=stubs, max_delay_ms=0,
                             max_batch=8)
    gate = None
    try:
        batcher = server._entry('s').batcher
        batcher.max_batch = 1          # what shrink_batch / brownout do
        assert server.scale_up('s') == 2
        assert stubs[1].warmed == [8]
        # a supervisor replacement of a wedged replica 0
        sup = server.supervise('s', wedge_ms=0, interval_s=0, start=False)
        gate, futs = _wedge_r0(server, stubs)
        assert [e['action'] for e in sup.tick()] == ['quarantine',
                                                     'replay', 'replace']
        assert stubs[2].warmed == [8]
        for f in futs:
            f.result(timeout=WAIT)
        # a reload: every replacement warms to the cap
        new = [_WarmStub() for _ in server._entry('s').replicas]
        server.reload_model('s', predictor=new)
        assert [s.warmed for s in new] == [[8]] * len(new)
        assert batcher.max_batch == 1 and batcher.configured_max_batch == 8
    finally:
        if gate is not None:
            gate.set()
        server.close(drain=False, timeout=WAIT)


# ---------------------------------------------------------------------------
# detector: the same verdicts on the same sequences
# ---------------------------------------------------------------------------

def _gate_verdicts(pkg):
    g = pkg.detector.HysteresisGate(up_after=2, down_after=3,
                                    cooldown_s=1.0)
    seq = [(True, False), (True, False), (False, True), (False, True),
           (False, True), (False, False), (True, False), (True, False),
           (True, False)]
    out = []
    now = 10.0
    for breach, clear in seq:
        v = g.observe(breach, clear, now=now)
        out.append(v)
        if v is not None:
            g.acted(now=now)
        now += 0.4           # the settle window swallows what follows
    out.append((g.breaches, g.clears, g.settling(now)))
    return out


def test_hysteresis_gate_verdicts_match():
    out = _both(_gate_verdicts)
    assert out[1] == 'breach' and 'clear' not in out[:4]


def _series_verdicts(pkg):
    rng = np.random.RandomState(7)
    out = []
    for direction in ('high', 'low', 'slope'):
        det = pkg.detector.SeriesDetector('s.%s' % direction,
                                          direction=direction, window=16,
                                          min_samples=6, fire_after=2,
                                          clear_after=3)
        vals = list(10.0 + rng.randn(20) * 0.1)
        if direction == 'slope':
            vals += [10.0 + 0.5 * i for i in range(20)]
        else:
            sign = 1.0 if direction == 'high' else -1.0
            vals += [10.0 + sign * 5.0] * 4 + list(10.0 + rng.randn(8) * 0.1)
        for i, v in enumerate(vals):
            r = det.observe(float(i), float(v))
            if r is not None:
                out.append((direction, i, r[0], round(r[1]['baseline'], 9),
                            round(r[1]['magnitude'], 9)))
    base = pkg.detector.RobustBaseline(window=8)
    for v in (1.0, 2.0, 3.0, 100.0):
        base.add(v)
    out.append((base.median(), base.mad()))
    out.append(pkg.detector.slope_of([(0.0, 1.0), (1.0, 3.0),
                                      (2.0, 5.0)]))
    out.append(_outcome(lambda: pkg.detector.SeriesDetector(
        'x', direction='sideways')))
    return out


def test_series_detector_verdicts_match():
    out = _both(_series_verdicts)
    kinds = {(d, k) for d, _, k, _, _ in out[:-3]}
    assert {('high', 'anomaly'), ('low', 'anomaly'),
            ('slope', 'anomaly')} <= kinds
    assert out[-1] == 'ValueError'
