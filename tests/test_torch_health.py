"""The training-health plane of the PyTorch port against the JAX package
on the CPU: the on-device sentinels folded into the fused fit step
(``health.py``, ``parallel/train_step.py``), the divergence actions
(warn / skip_update / abort), the metric drain that carries them, the
Speedometer's health column, the flight record's ``'health'`` key, and
``Module.fit`` with all four observability planes on in both packages.

The scenarios of ``tests/test_health.py`` run through both packages on
the same numpy data and initial parameters; their outcomes (detection
batch, counters, the bad-step range, parameters) must be equal.  Against
the JAX fused step over a narrow ResNet v2 (Pallas interpreter),
``nan_steps``, ``first_bad`` and ``last_bad`` are equal, ``grad_norm``
and ``update_ratio`` agree to rtol 1e-5 (float32), and the parameters
and the metric after a skipped step to rtol 1e-5 (tests/test_torch_train.py
holds trained parameters to rtol 1e-4 over three steps; here they are
compared after two)."""
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import chronicle as j_chronicle
from mxnet_tpu import health as j_health
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import chronicle as t_chronicle
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch.models import resnet as tresnet

PKGS = {'jax': mx, 'torch': tmx}
HEALTH = {'jax': j_health, 'torch': t_health}
KNOBS = ('MXTPU_HEALTH_SENTINELS', 'MXTPU_HEALTH_ACTION', 'MXTPU_FUSED_FIT',
         'MXTPU_DEVICE_METRICS', 'MXTPU_ASYNC_DEPTH', 'MXTPU_PERFWATCH',
         'MXTPU_IOWATCH', 'MXTPU_CHRONICLE', 'MXTPU_FUSE',
         'MXTPU_FORCE_PALLAS_INTERPRET', 'MXTPU_CHRONICLE_EVERY_MS')


def reset_planes():
    """Both packages' process-global plane state back to off: the health
    monitor and recorder, the goodput ledger, perfwatch, the chronicle's
    thread and the metrics registry."""
    for h in (j_health, t_health):
        h.deactivate()
        h._recorder = None
    for c in (j_chronicle, t_chronicle):
        c.stop()
    for io in (j_iowatch, t_iowatch):
        io._ledger = None
        io._last_snapshot = None
        io.set_enabled(False)
    for pw in (j_perfwatch, t_perfwatch):
        pw.set_enabled(False)
        pw.clear_executables()
        pw.ledger_reset()
        pw._step_window.clear()
    t_perfwatch._pending.clear()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    state = [(p.instrument, p.instrument.profiling_enabled(),
              p.instrument.metrics_enabled()) for p in (mx, tmx)]
    reset_planes()
    for ins, _, _ in state:
        ins.clear_trace()
        ins.reset_metrics()
        ins.set_metrics(True)
    yield
    reset_planes()
    for ins, prof, met in state:
        ins.set_profiling(prof)
        ins.set_metrics(met)
        ins.clear_trace()
        ins.reset_metrics()


def _mlp(pkg, classes=4):
    net = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(net, num_hidden=16, name='hfc1')
    net = pkg.sym.Activation(net, act_type='relu', name='hact1')
    net = pkg.sym.FullyConnected(net, num_hidden=classes, name='hfc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _cls_data(rng, n, d=10, classes=4):
    X = rng.randn(n, d).astype(np.float32)
    Y = (X @ rng.randn(d, classes)).argmax(1).astype(np.float32)
    return X, Y


def _mlp_params(d=10, classes=4):
    r = np.random.RandomState(11)
    return {'hfc1_weight': r.uniform(-.05, .05, (16, d)).astype(np.float32),
            'hfc1_bias': np.zeros(16, np.float32),
            'hfc2_weight': r.uniform(-.05, .05, (classes, 16))
            .astype(np.float32),
            'hfc2_bias': np.zeros(classes, np.float32)}


def _fit(name, monkeypatch, env, X, Y, bs, frequent=2, callbacks=None,
         eval_metric='acc'):
    """``Module.fit`` of the MLP in package ``name`` under ``env``, from
    the same initial parameters; returns (module, trained params)."""
    pkg = PKGS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    it = pkg.io.NDArrayIter(data=X, label=Y, batch_size=bs, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    cbs = [pkg.callback.Speedometer(bs, frequent)] + list(callbacks or [])
    try:
        mod.fit(it, num_epoch=1, optimizer='sgd',
                optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
                eval_metric=eval_metric,
                arg_params={k: pkg.nd.array(v)
                            for k, v in _mlp_params(X.shape[1]).items()},
                batch_end_callback=cbs)
    finally:
        for k in env:
            monkeypatch.delenv(k, raising=False)
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}


def _counters(name):
    return PKGS[name].instrument.metrics_snapshot()['counters']


def _both(scenario):
    got = {name: scenario(name) for name in ('jax', 'torch')}
    assert got['torch'] == got['jax'], got
    return got['torch']


# ---------------------------------------------------------------------------
# The scenarios of tests/test_health.py, in both packages
# ---------------------------------------------------------------------------

def test_nan_detected_within_one_drain_window(monkeypatch):
    """An injected non-finite batch surfaces in health.nan_steps at the
    first Speedometer drain at or after the bad step, under the async
    window, without a health-forced host sync."""
    rng = np.random.RandomState(0)
    bs, frequent, bad = 16, 2, 3
    X, Y = _cls_data(rng, 8 * bs)
    X[bad * bs + 1, 0] = np.nan

    def run(name):
        PKGS[name].instrument.reset_metrics()
        detected = []

        def watch(param):
            if not detected and _counters(name).get('health.nan_steps',
                                                    0) >= 1:
                detected.append(param.nbatch)
        mod, _ = _fit(name, monkeypatch,
                      {'MXTPU_HEALTH_SENTINELS': '1',
                       'MXTPU_HEALTH_ACTION': 'warn',
                       'MXTPU_ASYNC_DEPTH': '2'},
                      X, Y, bs, frequent=frequent, callbacks=[watch])
        snap = PKGS[name].instrument.metrics_snapshot()
        return {'key': mod._fused_health_key, 'detected': detected[:1],
                'nan_steps': snap['counters'].get('health.nan_steps'),
                'host_syncs': snap['counters'].get('health.host_syncs', 0),
                'steps': snap['gauges'].get('health.steps')}
    out = _both(run)
    assert out['key'] == 'warn' and out['host_syncs'] == 0
    assert out['detected'] and out['detected'][0] <= bad + frequent
    assert out['nan_steps'] >= 1 and out['steps'] == 8


def test_steady_state_sync_budget_unchanged(monkeypatch):
    """Sentinels ride the metric drains: metric.host_syncs is the same
    with them on and off, and health.host_syncs stays 0."""
    rng = np.random.RandomState(1)
    bs = 16
    X, Y = _cls_data(rng, 6 * bs)

    def run(name):
        out = []
        for on in ('0', '1'):
            PKGS[name].instrument.reset_metrics()
            _fit(name, monkeypatch, {'MXTPU_HEALTH_SENTINELS': on}, X, Y,
                 bs)
            c = _counters(name)
            out.append((c.get('metric.host_syncs', 0),
                        c.get('health.host_syncs', 0)))
        return out
    (m_off, _), (m_on, h_on) = _both(run)
    assert m_on == m_off > 0 and h_on == 0


def test_skip_update_leaves_params_bit_for_bit(monkeypatch):
    """Under skip_update an all-NaN epoch leaves the parameters exactly
    at their initial values; a run with one bad batch trains on, finite,
    with only that step counted."""
    rng = np.random.RandomState(2)
    bs, nbatch = 16, 4
    X, Y = _cls_data(rng, nbatch * bs)
    X[:, 0] = np.nan
    env = {'MXTPU_HEALTH_SENTINELS': '1',
           'MXTPU_HEALTH_ACTION': 'skip_update'}
    init = _mlp_params()

    def run(name):
        PKGS[name].instrument.reset_metrics()
        _, trained = _fit(name, monkeypatch, env, X, Y, bs)
        return {'nan_steps': _counters(name).get('health.nan_steps'),
                'same': all(np.array_equal(trained[k], init[k])
                            for k in init)}
    assert _both(run) == {'nan_steps': nbatch, 'same': True}

    X2, Y2 = _cls_data(np.random.RandomState(3), nbatch * bs)
    X2[bs + 1, 0] = np.inf
    params = {}

    def run2(name):
        PKGS[name].instrument.reset_metrics()
        _, params[name] = _fit(name, monkeypatch, env, X2, Y2, bs)
        return {'nan_steps': _counters(name).get('health.nan_steps'),
                'finite': all(np.isfinite(v).all()
                              for v in params[name].values()),
                'moved': any(not np.array_equal(params[name][k], init[k])
                             for k in init)}
    assert _both(run2) == {'nan_steps': 1, 'finite': True, 'moved': True}
    for k in init:
        np.testing.assert_allclose(params['torch'][k], params['jax'][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_abort_raises_with_step_range(monkeypatch):
    """abort raises TrainingDivergedError out of fit with the offending
    fused-step range, and the flight record's 'health' key is filled."""
    rng = np.random.RandomState(4)
    bs, bad = 16, 3
    X, Y = _cls_data(rng, 6 * bs)
    X[bad * bs, 0] = np.nan

    def run(name, tmp=None):
        PKGS[name].instrument.reset_metrics()
        HEALTH[name].install_flight_recorder(tmp)
        try:
            with pytest.raises(HEALTH[name].TrainingDivergedError) as exc:
                _fit(name, monkeypatch, {'MXTPU_HEALTH_SENTINELS': '1',
                                         'MXTPU_HEALTH_ACTION': 'abort'},
                     X, Y, bs, frequent=1)
        finally:
            HEALTH[name]._recorder = None
        e = exc.value
        with open(os.path.join(tmp, 'flightrec-rank0.json')) as f:
            doc = json.load(f)
        return {'range': (e.first_bad_step, e.last_bad_step, e.nan_steps),
                'in_message': str(bad) in str(e), 'reason': doc['reason'],
                'health': {k: doc['health'][k] for k in
                           ('nan_steps', 'first_bad_step', 'last_bad_step',
                            'steps')}}

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        got = {n: run(n, os.path.join(d, n)) for n in ('jax', 'torch')}
    assert got['torch'] == got['jax']
    assert got['torch']['range'] == (bad, bad, 1)
    assert got['torch']['reason'] == 'diverged'
    assert got['torch']['health']['nan_steps'] == 1


def test_sentinel_toggle_rebuilds_fused_step(monkeypatch):
    """A sentinel toggle between fits of one module rebuilds the fused
    step (the probe is part of it) and drops its graphs; the same
    action under a fresh monitor keeps them."""
    rng = np.random.RandomState(5)
    bs = 16
    X, Y = _cls_data(rng, 3 * bs)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    keys = []
    for on in ('1', '1', '0'):
        monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', on)
        mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=bs), num_epoch=1,
                optimizer_params={'learning_rate': 0.1})
        keys.append((mod._fused_health_key, id(mod._fused)))
    assert keys[0][0] == keys[1][0] == 'warn' and keys[2][0] is None
    assert keys[0][1] == keys[1][1] != keys[2][1]
    assert mod._fused is not None


def test_unfused_fit_warns_once(monkeypatch, caplog):
    """A fit forced onto the per-parameter loop with sentinels on warns
    once that the probe is inactive, in both packages."""
    rng = np.random.RandomState(7)
    bs = 16
    X, Y = _cls_data(rng, 3 * bs)

    def run(name):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mod, _ = _fit(name, monkeypatch,
                          {'MXTPU_HEALTH_SENTINELS': '1',
                           'MXTPU_FUSED_FIT': '0'}, X, Y, bs)
        return {'fused': mod._fused is not None,
                'warnings': sum('INACTIVE' in r.getMessage()
                                for r in caplog.records)}
    assert _both(run) == {'fused': False, 'warnings': 1}


def test_invalid_health_action_rejected(monkeypatch):
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'explode')
    for h in (j_health, t_health):
        with pytest.raises(ValueError):
            h.health_action()
    from mxnet_tpu_torch.parallel.train_step import (_PlainUpdate,
                                                     make_fit_step,
                                                     make_sgd_momentum)
    with pytest.raises(ValueError, match='health_action'):
        make_fit_step(_mlp(tmx), _PlainUpdate(make_sgd_momentum()),
                      health_action='explode')


def test_speedometer_health_column(monkeypatch, caplog):
    """Speedometer(health=True) (the JAX signature) appends the drained
    grad norm and nan count, and adds no host sync."""
    rng = np.random.RandomState(8)
    bs = 16
    X, Y = _cls_data(rng, 4 * bs)
    X[bs, 0] = np.nan
    with caplog.at_level(logging.INFO):
        _fit('torch', monkeypatch, {'MXTPU_HEALTH_SENTINELS': '1'}, X, Y,
             bs, callbacks=[tmx.callback.Speedometer(bs, 2, health=True)])
    lines = [r.getMessage() for r in caplog.records
             if 'nan_steps=' in r.getMessage()]
    assert lines and 'grad_norm=' in lines[-1]
    assert _counters('torch').get('health.host_syncs', 0) == 0


# ---------------------------------------------------------------------------
# The probe's parts against the JAX package
# ---------------------------------------------------------------------------

def test_probe_functions_match_jax():
    """all_finite_tree, l2_norm_tree, update_ratio and fold_state on the
    same arrays; a sum of squares that overflows float32 is still
    finite, a NaN anywhere is not."""
    import jax.numpy as jnp
    r = np.random.RandomState(9)
    tree = [r.randn(7, 3).astype(np.float32),
            r.randn(5).astype(np.float32)]
    new = [t + r.randn(*t.shape).astype(np.float32) * 0.1 for t in tree]
    jt = [jnp.asarray(t) for t in tree]
    tt = [torch.from_numpy(t) for t in tree]
    np.testing.assert_allclose(float(t_health.l2_norm_tree(tt)),
                               float(j_health.l2_norm_tree(jt)), rtol=1e-6)
    np.testing.assert_allclose(
        float(t_health.update_ratio(tt, [torch.from_numpy(t)
                                         for t in new])),
        float(j_health.update_ratio(jt, [jnp.asarray(t) for t in new])),
        rtol=1e-6)
    big = [np.full((4,), 3e38, np.float32)]
    nan = [tree[0], np.array([1.0, np.nan], np.float32)]
    for case in (tree, big, nan):
        assert bool(t_health.all_finite_tree(
            [torch.from_numpy(a) for a in case])) == \
            bool(j_health.all_finite_tree([jnp.asarray(a) for a in case]))
    js, ts = j_health.init_state(), t_health.init_state()
    for ok, g, u in ((True, 1.5, 0.1), (False, 2.0, 0.2), (True, 3.0, 0.3),
                     (False, 4.0, 0.4)):
        js = j_health.fold_state(js, jnp.bool_(ok), jnp.float32(g),
                                 jnp.float32(u))
        t_health.fold_state(ts, torch.tensor(ok), torch.tensor(g),
                            torch.tensor(u))
    assert ts[0].tolist() == [int(v) for v in js[:4]]
    np.testing.assert_allclose(ts[1].numpy(),
                               [float(js[4]), float(js[5])], rtol=0)


def _narrow_resnet(res):
    return res.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[8, 16, 32, 64, 128], num_classes=10,
                      image_shape=(3, 64, 64))


def test_resnet_skip_update_matches_jax(monkeypatch):
    """Four steps of the narrow ResNet v2 under MXTPU_FUSE=aggressive and
    skip_update, a NaN pixel in batch 1, in both packages: the same bad
    step range, the same grad_norm and update_ratio at the last drain
    (rtol 1e-5), and after the skipped step the same parameters, aux and
    metric (rtol 1e-5); the metric's instance count excludes the skipped
    step exactly."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'skip_update')
    batch, steps, bad = 4, 4, 1
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    x[bad * batch + 2, 1, 5, 7] = np.nan
    got = {}
    for name, pkg in PKGS.items():
        sym = pkg.sym.load_json(tsym.tojson())
        metric = pkg.metric.create('ce')
        seen = []

        def probe(param, name=name):
            if param.nbatch == bad:
                m = param.locals['self']
                a, x_ = m.get_params()
                seen.append(({k: v.asnumpy() for k, v in a.items()},
                             {k: v.asnumpy() for k, v in x_.items()}))
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
                optimizer='sgd',
                optimizer_params={'learning_rate': 0.05, 'momentum': 0.9,
                                  'wd': 1e-4},
                eval_metric=metric,
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
                aux_params={k: pkg.nd.array(v) for k, v in aux.items()},
                batch_end_callback=probe)
        snap = pkg.instrument.metrics_snapshot()
        got[name] = {'counters': snap['counters'].get('health.nan_steps'),
                     'gauges': {k: snap['gauges'][k] for k in
                                ('health.grad_norm', 'health.update_ratio',
                                 'health.steps')},
                     'metric': (metric.sum_metric, metric.num_inst),
                     'after_bad': seen[0],
                     'params': {k: v.asnumpy()
                                for k, v in mod.get_params()[0].items()}}
    t, j = got['torch'], got['jax']
    assert t['counters'] == j['counters'] == 1
    assert t['gauges']['health.steps'] == j['gauges']['health.steps'] == 4
    for k in ('health.grad_norm', 'health.update_ratio'):
        np.testing.assert_allclose(t['gauges'][k], j['gauges'][k],
                                   rtol=1e-5, err_msg=k)
    assert t['metric'][1] == j['metric'][1] == batch * (steps - 1)
    np.testing.assert_allclose(t['metric'][0], j['metric'][0], rtol=1e-5)
    for i in (0, 1):
        for k, v in j['after_bad'][i].items():
            np.testing.assert_allclose(t['after_bad'][i][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for k, v in j['params'].items():
        assert np.isfinite(t['params'][k]).all(), k


def test_bucketing_module_threads_the_sentinels(monkeypatch):
    """BucketingModule.fit over a BucketSentenceIter with sentinels on,
    in both packages: every bucket's fused step folds the probe into the
    one health state (steps counted across buckets), with the JAX
    package's grad_norm and update_ratio at the last drain (rtol 1e-5)
    and no health-forced sync."""
    import random
    from mxnet_tpu.models import transformer_lm as jlm
    from mxnet_tpu_torch.models import transformer_lm as tlm
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    cfg = dict(vocab_size=50, num_embed=16, num_heads=2, num_layers=1,
               max_seq_len=12)
    rows = 4
    sym = tlm.sym_gen_bucketing(**cfg)(12)[0]
    arg = convert.random_params(sym, {'data': (rows, 12),
                                      'softmax_label': (rows, 12)}, 0,
                                init='normal')[0]
    rng = np.random.RandomState(5)
    sentences = [list(rng.randint(1, 50, rng.randint(3, 13)))
                 for _ in range(16)]
    got = {}
    for name, lm in (('torch', tlm), ('jax', jlm)):
        pkg = PKGS[name]
        random.seed(7)
        np.random.seed(7)
        it = pkg.rnn.BucketSentenceIter(sentences, rows, buckets=[6, 12])
        mod = pkg.mod.BucketingModule(lm.sym_gen_bucketing(**cfg),
                                      default_bucket_key=12,
                                      context=pkg.cpu())
        mod.fit(it, num_epoch=1, optimizer='sgd',
                optimizer_params={'learning_rate': 0.05, 'momentum': 0.9},
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
        snap = pkg.instrument.metrics_snapshot()
        got[name] = {
            'keys': sorted({m._fused_health_key
                            for m in mod._buckets.values()}),
            'buckets': sorted(mod._buckets),
            'steps': snap['gauges']['health.steps'],
            'batches': snap['counters']['io.batches'],
            'syncs': snap['counters'].get('health.host_syncs', 0),
            'norms': [snap['gauges']['health.grad_norm'],
                      snap['gauges']['health.update_ratio']]}
    t, j = got['torch'], got['jax']
    np.testing.assert_allclose(t.pop('norms'), j.pop('norms'), rtol=1e-5)
    assert t == j
    assert t['keys'] == ['warn'] and t['buckets'] == [6, 12]
    assert t['steps'] == t['batches'] > 2 and t['syncs'] == 0


def test_skip_update_restores_every_state_of_the_step(monkeypatch):
    """On the CPU, in the port: after a skipped step the parameters, the
    optimizer state, aux and the metric's device accumulator are bit for
    bit their values before it, and the step's instances are held back
    (the drained count excludes them)."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'skip_update')
    batch, steps, bad = 4, 4, 2
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    x[bad * batch, 0, 3, 3] = np.inf
    metric = tmx.metric.create('acc')
    seen = []

    def snap(param):
        m = param.locals['self']
        a, x_ = m.get_params()
        seen.append(({k: v.asnumpy() for k, v in a.items()},
                     {k: v.asnumpy() for k, v in x_.items()},
                     {k: v.numpy().copy()
                      for k, v in m._fused_opt_state.items()},
                     {'sum': metric._dev_sum.numpy().copy(),
                      'held': float(metric._dev_held)}))
    mod = tmx.mod.Module(tsym, context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
            optimizer='sgd',
            optimizer_params={'learning_rate': 0.05, 'momentum': 0.9},
            eval_metric=metric,
            arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
            batch_end_callback=snap)
    before, after = seen[bad - 1], seen[bad]
    for part in range(3):
        assert set(after[part]) == set(before[part])
        for k, v in before[part].items():
            np.testing.assert_array_equal(after[part][k], v, err_msg=k)
    np.testing.assert_array_equal(after[3]['sum'], before[3]['sum'])
    assert (before[3]['held'], after[3]['held']) == (0.0, float(batch))
    assert metric.num_inst == batch * (steps - 1)
    assert any(not np.array_equal(seen[-1][0][k], after[0][k])
               for k in after[0])
