"""The serving fleet's data plane, scenario against scenario: the same
scripted traffic runs through ``mxnet_tpu.serving.ModelServer`` and
``mxnet_tpu_torch.serving.ModelServer`` on the CPU, and each scenario's
observable outcome (responses, typed errors, flush order by lane,
replica counts, counters) must be the same in both packages.

Replicas are prebuilt Predictor-shaped stubs whose forward can be held
on a ``threading.Event``, so every interleaving that matters is forced,
not slept into; every wait is bounded.  The cases follow the reference's
own (``tests/test_serving_fleet.py``: the shared queue, scale-down
drains and the last-replica guard, a scale-up into a freed slot, a
reload of every replica, lane preemption and the starvation valve,
per-lane admission bounds, prebuilt-count validation, unload dropping
every labeled series; the autoscaler's cases are in
``test_torch_autoscale.py``, the mesh's wait for their module).  One real-model case serves a narrow ResNet v2 from two
port replicas against the JAX Predictor, rtol 1e-5, atol 1e-7.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import instrument as j_instrument
from mxnet_tpu import resilience as j_resilience
from mxnet_tpu import serving as j_serving
from mxnet_tpu.models import resnet as j_resnet
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import instrument as t_instrument
from mxnet_tpu_torch import resilience as t_resilience
from mxnet_tpu_torch import serving as t_serving

JAX = SimpleNamespace(name='jax', serving=j_serving,
                      instrument=j_instrument, resilience=j_resilience,
                      server_kw={})
TORCH = SimpleNamespace(name='torch', serving=t_serving,
                        instrument=t_instrument, resilience=t_resilience,
                        server_kw={'dev_type': 'cpu'})
WAIT = 30            # seconds: the bound on every wait in this file
SHAPES = {'data': (8, 6)}


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


def _both(scenario, close=()):
    """Run ``scenario(pkg)`` on each package; the outcomes must be equal,
    those under the keys in ``close`` within rtol 1e-5 (model outputs).
    Returns the port's."""
    got = {p.name: scenario(p) for p in (JAX, TORCH)}
    for k in close:
        np.testing.assert_allclose(got['torch'].pop(k), got['jax'].pop(k),
                                   rtol=1e-5, atol=1e-7)
    assert got['torch'] == got['jax']
    return got['torch']


class _Stub(object):
    """Predictor-shaped replica: ``out = 2 * data[:, :1] + tag``.  With
    ``gate`` set, a forward waits on it (bounded) after announcing
    itself on ``entered``; ``calls`` logs each forward's first column."""

    def __init__(self, tag=0.0, gate=None):
        self._input_shapes = dict(SHAPES)
        self._batch_inputs = {'data'}
        self.num_outputs = 1
        self.tag = tag
        self.gate = gate
        self.entered = threading.Event()
        self.calls = []
        self._out = None

    def forward(self, **kw):
        x = np.asarray(kw['data'], np.float32)
        self.calls.append([float(v) for v in x[:, 0]])
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=WAIT)
        self._out = 2.0 * x[:, :1] + self.tag

    def get_output(self, i):
        return self._out


def _x(v, rows=1):
    return np.full((rows, 6), v, np.float32)


def _stub_server(pkg, n=1, stubs=None, **kw):
    """A server over stubs: slot 0 prebuilt, later slots (scale_up, the
    supervisor's replacements) from a builder override."""
    stubs = stubs or [_Stub() for _ in range(4)]
    server = pkg.serving.ModelServer(**pkg.server_kw, **kw)
    server.load_model('s', predictor=stubs[0], input_shapes=dict(SHAPES),
                      warm_start=False)
    orig = server._build_predictor

    def build(slot=0, **bkw):
        return stubs[slot] if slot < len(stubs) else orig(slot=slot, **bkw)
    server._build_predictor = build
    for _ in range(1, n):
        server.scale_up('s')
    return server, stubs


def _counters(pkg, prefix='serving.'):
    snap = pkg.instrument.metrics_snapshot().get('counters') or {}
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def _err(fut):
    """A resolved future's outcome: its rows as a list, or the error's
    type name."""
    try:
        return fut.result(timeout=WAIT)[0].ravel().tolist()
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__


def _gate(stubs):
    """Gate the first two stubs from now on (after any warm-up forward);
    returns their gates."""
    gates = [threading.Event(), threading.Event()]
    for s, g in zip(stubs, gates):
        s.gate = g
        s.entered.clear()
        s.calls.clear()
    return gates


def _hold_both(server, stubs, values=(1.0, 2.0)):
    """Both replicas of a max_batch=1 server each take one request and
    hold it (their stubs gated); returns the two futures."""
    server.pause('s')
    futs = [server.submit('s', data=_x(v)) for v in values]
    server.resume('s')
    assert stubs[0].entered.wait(WAIT) and stubs[1].entered.wait(WAIT)
    return futs


# ---------------------------------------------------------------------------
# Replica fleet mechanics
# ---------------------------------------------------------------------------

def _shared_queue(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gates = _gate(stubs)
    try:
        out = {'workers': server._entry('s').batcher.workers()}
        futs = _hold_both(server, stubs)
        for g in gates:
            g.set()
        out['responses'] = sorted(_err(f) for f in futs)
        # neither replica absorbed both: each took one from the queue
        out['calls'] = sorted(len(s.calls) for s in stubs[:2])
        snap = pkg.instrument.metrics_snapshot()
        out['counters'] = {k: v for k, v in _counters(pkg).items()
                           if k.startswith('serving.flushes')
                           or k in ('serving.requests',
                                    'serving.batched_requests')}
        out['replicas_gauge'] = snap['gauges']['serving.replicas|model=s']
        out['exec_hists'] = sorted(
            k for k in snap['histograms']
            if k.startswith('serving.execute_secs|'))
        return out
    finally:
        for g in gates:
            g.set()
        server.close(drain=False, timeout=WAIT)


def test_fleet_shares_one_queue_across_replicas():
    out = _both(_shared_queue)
    assert out['workers'] == [0, 1] and out['calls'] == [1, 1]
    assert out['counters']['serving.flushes'] == 2
    assert out['counters']['serving.flushes|model=s,replica=1'] == 1


def _scale_down_drains(pkg):
    server, stubs = _stub_server(pkg, n=2, max_delay_ms=0, max_batch=1)
    gates = _gate(stubs)
    try:
        futs = _hold_both(server, stubs)
        res = []
        t = threading.Thread(target=lambda: res.append(
            server.scale_down('s')))
        t.start()
        # the removed replica (the newest, r1) finishes its flush first
        t.join(timeout=0.2)
        out = {'waited_for_flush': t.is_alive()}
        gates[1].set()
        t.join(timeout=WAIT)
        out['scale_down'] = res
        out['workers'] = server._entry('s').batcher.workers()
        gates[0].set()
        out['drained'] = sorted(_err(f) for f in futs)
        out['served_after'] = server.predict(
            's', data=_x(3.0), timeout=WAIT)[0].ravel().tolist()
        out['last_guard'] = server.scale_down('s')
        batcher = server._entry('s').batcher
        server.pause('s')
        queued = [server.submit('s', data=_x(4.0)) for _ in range(3)]
        batcher.remove_worker(0)
        out['shed'] = [_err(f) for f in queued]
        try:
            batcher.submit({'data': _x(5.0)})
            out['late_submit'] = 'admitted'
        except Exception as e:             # noqa: BLE001 - the outcome
            out['late_submit'] = type(e).__name__
        return out
    finally:
        for g in gates:
            g.set()
        server.close(drain=False, timeout=WAIT)


def test_scale_down_drains_and_last_replica_guard():
    out = _both(_scale_down_drains)
    assert out['waited_for_flush'] and out['scale_down'] == [1]
    assert out['drained'] == [[2.0], [4.0]]
    assert out['last_guard'] is None
    assert out['shed'] == ['ServerOverloadedError'] * 3
    assert out['late_submit'] == 'MXNetError'


def _scale_up_and_reload(pkg):
    server, stubs = _stub_server(pkg, n=3, max_delay_ms=0)
    try:
        out = {'down': server.scale_down('s'),     # frees slot 2
               'up': server.scale_up('s'),         # takes it again
               'workers': server._entry('s').batcher.workers()}
        news = [_Stub(tag=10.0), _Stub(tag=10.0), _Stub(tag=10.0)]
        server.reload_model('s', predictor=news)
        entry = server._entry('s')
        out['swapped'] = [r.predictor is n
                          for r, n in zip(entry.replicas, news)]
        out['generation'] = entry.generation
        out['after'] = server.predict('s', data=_x(1.0),
                                      timeout=WAIT)[0].ravel().tolist()
        # each replacement was warmed through its pow2 buckets first
        out['warm_rows'] = [sorted(len(c) for c in n.calls[:7])
                            for n in news]
        out['counters'] = {k: _counters(pkg).get(k) for k in (
            'serving.scale_ups', 'serving.scale_downs', 'serving.reloads')}
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_scale_up_reuses_freed_slot_and_reload_swaps_every_replica():
    out = _both(_scale_up_and_reload)
    assert out['down'] == 2 and out['up'] == 3
    assert out['workers'] == [0, 1, 2] and out['swapped'] == [True] * 3
    assert out['generation'] == 1 and out['after'] == [12.0]
    assert out['counters'] == {'serving.scale_ups': 3,
                               'serving.scale_downs': 1,
                               'serving.reloads': 1}


# ---------------------------------------------------------------------------
# Priority lanes
# ---------------------------------------------------------------------------

def _preemption(pkg):
    server, stubs = _stub_server(pkg, n=1, max_delay_ms=1000, max_batch=1)
    try:
        server.pause('s')
        fb = [server.submit('s', data=_x(10.0 + i)) for i in range(3)]
        fi = [server.submit('s', priority='interactive', data=_x(i))
              for i in range(2)]
        server.resume('s')
        out = {'responses': [_err(f) for f in fb + fi]}
        out['order'] = [c[0] for c in stubs[0].calls]
        c = _counters(pkg)
        out['counters'] = {k: c.get(k, 0) for k in (
            'serving.preempt_flushes', 'serving.full_flushes',
            'serving.starvation_flushes', 'serving.flushes')}
        hists = pkg.instrument.metrics_snapshot()['histograms']
        out['lane_series'] = sorted(k for k in hists
                                    if k.startswith('serving.e2e_secs|'))
        try:
            server.submit('s', priority='urgent', data=_x(0.0))
            out['bad_lane'] = 'admitted'
        except Exception as e:             # noqa: BLE001 - the outcome
            out['bad_lane'] = type(e).__name__
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_priority_lane_preempts_batch_at_flush_boundaries():
    out = _both(_preemption)
    # ONE worker, one request a flush: interactive strictly first
    assert out['order'] == [0.0, 1.0, 10.0, 11.0, 12.0]
    assert out['counters'] == {'serving.preempt_flushes': 2,
                               'serving.full_flushes': 5,
                               'serving.starvation_flushes': 0,
                               'serving.flushes': 5}
    assert 'serving.e2e_secs|lane=interactive,model=s,replica=0' in \
        out['lane_series']
    assert out['bad_lane'] == 'MXNetError'


def _starvation_valve(pkg):
    server, stubs = _stub_server(pkg, n=1, max_delay_ms=1000, max_batch=1)
    try:
        batcher = server._entry('s').batcher
        batcher.starve_after = 10.0
        server.pause('s')
        fb = [server.submit('s', data=_x(10.0 + i)) for i in range(2)]
        fi = [server.submit('s', priority='interactive', data=_x(i))
              for i in range(3)]
        with batcher._cond:
            for req in batcher._queue:
                req.t_enqueue -= 100.0     # both batch requests starved
        server.resume('s')
        out = {'responses': [_err(f) for f in fb + fi],
               'order': [c[0] for c in stubs[0].calls]}
        c = _counters(pkg)
        out['counters'] = {k: c.get(k, 0) for k in (
            'serving.starvation_flushes', 'serving.preempt_flushes')}
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_batch_lane_starvation_valve_is_rate_limited():
    out = _both(_starvation_valve)
    # the valve serves ONE starved batch flush ahead of the interactive
    # lane, then holds off for starve_after: the second waits its turn
    assert out['order'] == [10.0, 0.0, 1.0, 2.0, 11.0]
    assert out['counters'] == {'serving.starvation_flushes': 1,
                               'serving.preempt_flushes': 3}


def _lane_bounds(pkg):
    server, _ = _stub_server(pkg, n=1, max_delay_ms=0, max_queue=2)
    try:
        server.pause('s')
        out = {'admitted': [_err_free(server.submit, 's', data=_x(1.0))
                            for _ in range(3)]}
        fi = server.submit('s', priority='interactive', data=_x(2.0))
        out['shed_series'] = {k: v for k, v in _counters(pkg).items()
                              if k.startswith('serving.shed_total')}
        server.resume('s')
        out['interactive'] = _err(fi)
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def _err_free(fn, *a, **kw):
    """'ok' when ``fn`` admits, else the error's type name."""
    try:
        fn(*a, **kw)
        return 'ok'
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__


def test_per_lane_admission_bounds_are_independent():
    out = _both(_lane_bounds)
    assert out['admitted'] == ['ok', 'ok', 'ServerOverloadedError']
    # a full batch lane does not shed interactive traffic
    assert out['shed_series'] == {
        'serving.shed_total': 1,
        'serving.shed_total|model=s,lane=batch': 1}
    assert out['interactive'] == [4.0]


# ---------------------------------------------------------------------------
# Prebuilt fleets, unload
# ---------------------------------------------------------------------------

def _mlp():
    net = jmx.sym.Variable('data')
    net = jmx.sym.FullyConnected(net, num_hidden=8, name='ffc1')
    net = jmx.sym.Activation(net, act_type='relu', name='fact1')
    net = jmx.sym.FullyConnected(net, num_hidden=4, name='ffc2')
    net = jmx.sym.SoftmaxOutput(net, name='softmax')
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(data=SHAPES['data'])
    arg = {n: rng.randn(*s).astype(np.float32) * 0.3
           for n, s in zip(net.list_arguments(), arg_shapes)
           if n not in ('data', 'softmax_label')}
    return net.tojson(), arg


def _params(pkg, arg):
    if pkg is JAX:
        return {k: jmx.nd.array(v) for k, v in arg.items()}
    return convert.params_from_numpy(arg, {}, 'cpu')


def _prebuilt(pkg):
    out = {}
    with pkg.serving.ModelServer(**pkg.server_kw) as server:
        out['too_many'] = _err_free(
            server.load_model, 'a', predictor=[_Stub(), _Stub()],
            input_shapes=dict(SHAPES), warm_start=False)
        out['too_few'] = _err_free(
            server.load_model, 'a', predictor=[_Stub()], replicas=2,
            input_shapes=dict(SHAPES), warm_start=False)
        # names become metric labels: label metacharacters are refused
        out['bad_names'] = [_err_free(
            server.load_model, bad, predictor=_Stub(),
            input_shapes=dict(SHAPES), warm_start=False)
            for bad in ('a,lane=x', 'a|b', 'a"b', 'a b')]
        out['reserved'] = _err_free(
            server.load_model, 'a', predictor=_Stub(),
            input_shapes={'deadline_ms': (8, 6)}, warm_start=False)
        sym_json, arg = _mlp()
        server.load_model('m', symbol_json=sym_json,
                          params=_params(pkg, arg),
                          input_shapes=dict(SHAPES), warm_start=False)
        out['built'] = server.predict('m', data=_x(0.5, 2),
                                      timeout=WAIT)[0]
        server.reload_model('m', predictor=_Stub(tag=7.0))
        out['after_reload'] = server.predict(
            'm', data=_x(0.5), timeout=WAIT)[0].ravel().tolist()
        # the prebuilt reload dropped the builder source: scale_up
        # refuses loudly instead of building the OLD model
        out['scale_up'] = _err_free(server.scale_up, 'm')
        out['reload_count'] = _err_free(server.reload_model, 'm',
                                        predictor=[_Stub(), _Stub()])
        out['replicas'] = server.replica_count('m')
    return out


def test_prebuilt_count_validation_and_reload_invalidates_builder():
    out = _both(_prebuilt, close=('built',))
    assert out['too_many'] == out['too_few'] == 'MXNetError'
    assert out['bad_names'] == ['MXNetError'] * 4
    assert out['reserved'] == 'MXNetError'
    assert out['after_reload'] == [8.0]
    assert out['scale_up'] == out['reload_count'] == 'MXNetError'
    assert out['replicas'] == 1


def _unload(pkg):
    server, _ = _stub_server(pkg, n=2, max_delay_ms=0)
    try:
        server.predict('s', data=_x(1.0), timeout=WAIT)
        labeled = lambda: sorted(                     # noqa: E731
            k for kind in ('counters', 'gauges', 'histograms')
            for k in (pkg.instrument.metrics_snapshot().get(kind) or {})
            if (pkg.instrument.split_labeled_name(k)[1] or {})
            .get('model') == 's')
        before = labeled()
        server.unload_model('s', drain=False)
        out = {'had_series': 'serving.replicas|model=s' in before,
               'left': labeled(),
               'models': server.models(),
               'gauge': pkg.instrument.metrics_snapshot()['gauges'][
                   'serving.models']}
        out['predict'] = _err_free(server.predict, 's', data=_x(1.0))
        return out
    finally:
        server.close(drain=False, timeout=WAIT)


def test_unload_drops_every_labeled_series():
    out = _both(_unload)
    assert out == {'had_series': True, 'left': [], 'models': [],
                   'gauge': 0, 'predict': 'ModelNotFoundError'}


def test_autoscale_and_mesh_wait_for_their_modules():
    """The autoscaler has landed (autoscale, autoscaler and
    replica_capacity answer, and the export lists are equal); the
    tensor-parallel replicas still raise, naming ROADMAP item 8."""
    server, _ = _stub_server(TORCH, n=1)
    try:
        assert server.autoscaler is None
        assert server.replica_capacity('s') == 1 << 30
        sc = server.autoscale('s', slo_p99_ms=5.0, interval_s=0,
                              start=False)
        assert server.autoscaler is sc and sc.watched() == ['s']
        for call in (lambda: server.load_model('m', predictor=_Stub(),
                                               input_shapes=dict(SHAPES),
                                               mesh='1x1'),
                     lambda: server.reload_model('s', partition='auto')):
            with pytest.raises(tmx.MXNetError, match='item 8'):
                call()
    finally:
        server.close(drain=False, timeout=WAIT)
    assert set(j_serving.__all__) == set(t_serving.__all__)


def test_gpu_server_refuses_unwarmed_replicas():
    # a GPU replica serves only captured buckets: no capture on the
    # request path (the host server keeps the reference's warm=False)
    gpu = t_serving.ModelServer()
    for call in (lambda: gpu._refuse_cold(False),
                 lambda: gpu.scale_up('s', warm=False)):
        with pytest.raises(tmx.MXNetError, match='request path'):
            call()
    gpu._refuse_cold(True)
    server, _ = _stub_server(TORCH, n=1)
    try:
        assert server.scale_up('s', warm=False) == 2
    finally:
        server.close(drain=False, timeout=WAIT)


def test_replica_builds_reuse_shape_inference(monkeypatch):
    # a second Predictor of one model at the same buckets (a replica, a
    # reload) binds from the remembered shapes, with the same outputs
    from mxnet_tpu_torch import symbol as t_symbol
    sym_json, arg = _mlp()
    sym_json = sym_json.replace('ffc1', 'ffc1_cache')     # a fresh key
    arg = {k.replace('ffc1', 'ffc1_cache'): v for k, v in arg.items()}
    calls = []
    real = t_symbol.Symbol.infer_shape

    def counted(self, *a, **kw):
        calls.append(kw)
        return real(self, *a, **kw)
    monkeypatch.setattr(t_symbol.Symbol, 'infer_shape', counted)
    outs, inferred = [], []
    for _ in range(2):
        del calls[:]
        pred = tmx.Predictor(sym_json, _params(TORCH, arg), dict(SHAPES),
                             dev_type='cpu', pad_to_bucket=True)
        assert pred.warm_buckets(8) == [1, 2, 4, 8]
        pred.forward(data=_x(0.5, 3))
        outs.append(pred.get_output(0))
        inferred.append(sorted(kw['data'][0] for kw in calls))
    # the first build infers its bound shape (8 rows) and buckets 1, 2, 4
    assert inferred == [[1, 2, 4, 8], []]
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# A real model: a narrow ResNet v2 from two port replicas against JAX
# ---------------------------------------------------------------------------

KW = dict(units=[1, 1, 1, 1], num_stages=4,
          filter_list=[8, 16, 32, 64, 128], num_classes=10,
          image_shape=(3, 32, 32))
RSHAPE = (8, 3, 32, 32)


def test_two_port_replicas_serve_resnet_like_the_jax_predictor(
        monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    with jmx.base.NameManager():
        sym_json = j_resnet.resnet(**KW).tojson()
    arg, aux = convert.random_params(tmx.sym.load_json(sym_json),
                                     {'data': RSHAPE}, seed=3)
    rng = np.random.RandomState(4)
    data = rng.randn(*RSHAPE).astype(np.float32)
    params = {'arg:' + k: jmx.nd.array(v) for k, v in arg.items()}
    params.update({'aux:' + k: jmx.nd.array(v) for k, v in aux.items()})
    jpred = JaxPredictor(sym_json, params, {'data': RSHAPE},
                         pad_to_bucket=True)
    server = t_serving.ModelServer(max_delay_ms=0, max_batch=8,
                                   dev_type='cpu')
    try:
        server.load_model('resnet', symbol_json=sym_json,
                          params=convert.params_from_numpy(arg, aux, 'cpu'),
                          input_shapes={'data': RSHAPE}, replicas=2)
        entry = server._entry('resnet')
        preds = [r.predictor for r in entry.replicas]
        assert len(preds) == 2 and preds[0] is not preds[1]
        # each replica owns its parameters
        w = [p._executor.arg_dict['fc1_weight'].handle for p in preds]
        assert w[0].data_ptr() != w[1].data_ptr()
        server.pause('resnet')
        cases = [(0, 1), (1, 3), (3, 7), (7, 8)]
        futs = [server.submit('resnet', data=data[a:b]) for a, b in cases]
        server.resume('resnet')
        for (a, b), f in zip(cases, futs):
            got = f.result(timeout=WAIT)[0]
            jpred.forward(data=data[a:b])
            np.testing.assert_allclose(got, jpred.get_output(0),
                                       rtol=1e-5, atol=1e-7)
    finally:
        server.close(timeout=WAIT)
