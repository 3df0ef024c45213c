"""The serving side of the mesh, against the JAX package on the CPU:
``Predictor(mesh=, partition=, devices=)`` over ``[cpu(0), ...]``, alone
and behind a ``ModelServer``, the sharding-inspector records, the submesh
helpers, the sharded path's guards and the server's capacity rule.

The JAX package's own contract (``tools/check_fleet.py:183-259``):
``tools/check_fleet.py``'s integer MLP (column-parallel first layer,
row-parallel second) served sharded is bit for bit the unsharded JAX
Predictor at the same bucket (its integer logits; the softmax on them is
each library's own); float payloads within rtol 1e-6 of the unsharded
forward in the same library, 1e-5 of the JAX package's.  Here each dp
slot runs its ``B/dp`` rows as one unsharded forward at that bucket, so
the oracle is the Predictor run slice by slice.  A narrow ResNet v2
(``MXTPU_FUSE=aggressive``) is held to rtol 1e-5, atol 1e-7 against the
JAX package.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as j_serving
from mxnet_tpu.models import resnet as j_resnet
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import instrument as t_instrument
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import ModelServer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
from check_fleet import int_mlp  # noqa: E402

MESHES = ('1x1', '1x2', '2x1', '2x2')
WAIT = 60


def _dims(mesh):
    dp, tp = (int(v) for v in mesh.split('x'))
    return dp, tp


def _cpus(n):
    return [tmx.cpu(i) for i in range(n)]


@pytest.fixture(scope='module')
def mlp():
    sym_json, params, shapes, partition = int_mlp()
    return sym_json, {k: v.asnumpy() for k, v in params.items()}, shapes, \
        partition


@pytest.fixture(autouse=True)
def _metrics_on():
    was = t_instrument.metrics_enabled()
    t_instrument.set_metrics(True)
    yield
    t_instrument.set_metrics(was)


def _sharded(sym_json, params, shapes, mesh, partition):
    dp, tp = _dims(mesh)
    return Predictor(sym_json, params, dict(shapes), mesh=mesh,
                     partition=partition, devices=_cpus(dp * tp))


def _slot_oracle(oracle, x, dp):
    """What the sharded forward serves for ``x``: the JAX Predictor run on
    each dp slot's ``B/dp`` rows (the padded request split in slot
    order), concatenated and cut to the request's rows."""
    rows = x.shape[0]
    bucket = tmx.compile_cache.pad_to_bucket(rows, minimum=dp)
    per = bucket // dp
    padded = np.concatenate([x, np.zeros((bucket - rows,) + x.shape[1:],
                                         np.float32)])
    outs = []
    for d in range(dp):
        oracle.forward(data=padded[d * per:(d + 1) * per])
        outs.append(oracle.get_output(0))
    return np.concatenate(outs)[:rows]


@pytest.mark.parametrize('mesh', MESHES)
def test_int_mlp_bit_for_bit_alone_and_behind_a_server(mlp, mesh):
    """Integer logits (the MLP's ``sfc2`` output) are exact in both
    packages, so the sharded port's equal the unsharded JAX Predictor's
    bit for bit.  The softmax on them is each library's own (XLA's CPU
    backend flushes denormals, torch's exp rounds its own way): the
    sharded probabilities equal the port's unsharded Predictor bit for
    bit and the JAX package's within rtol 1e-6, atol 1e-7."""
    sym_json, params, shapes, partition = mlp
    dp, _ = _dims(mesh)
    d_in = shapes['data'][1]
    jparams = {k: jmx.nd.array(v) for k, v in params.items()}
    oracle = JaxPredictor(sym_json, jparams, dict(shapes),
                          pad_to_bucket=True, output_keys=['sfc2'])
    joracle = JaxPredictor(sym_json, jparams, dict(shapes),
                           pad_to_bucket=True)
    toracle = Predictor(sym_json, params, dict(shapes), dev_type='cpu',
                        pad_to_bucket=True)
    tlogits = Predictor(sym_json, params, dict(shapes), dev_type='cpu',
                        pad_to_bucket=True, output_keys=['sfc2'])
    dp, tp = _dims(mesh)
    sp = Predictor(sym_json, params, dict(shapes), mesh=mesh,
                   partition=partition, devices=_cpus(dp * tp),
                   output_keys=['sfc2'])
    prob = _sharded(sym_json, params, shapes, mesh, partition)
    assert sp.warm_buckets(8) == [b for b in (1, 2, 4, 8) if b >= dp]
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 4, (1 + i % 5, d_in)).astype(np.float32)
                for i in range(12)]
    for x in payloads:
        sp.forward(data=x)
        got = sp.get_output(0)
        want = _slot_oracle(oracle, x, dp)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert sp._active_bucket == tmx.compile_cache.pad_to_bucket(
            x.shape[0], minimum=dp)
        prob.forward(data=x)
        p = prob.get_output(0)
        assert np.array_equal(p, _slot_oracle(toracle, x, dp))
        np.testing.assert_allclose(p, _slot_oracle(joracle, x, dp),
                                   rtol=1e-6, atol=1e-7)

    # behind a server: a flush's rows ride one bucket; integer logits
    # make a row's output independent of the rows beside it, so each
    # response must equal the oracle at some bucket (check_fleet's rule)
    wants = []
    for x in payloads:
        per_bucket = []
        for b in (1, 2, 4, 8):
            if b >= x.shape[0]:
                oracle.forward(data=np.concatenate(
                    [x, np.zeros((b - x.shape[0], d_in), np.float32)]))
                per_bucket.append(oracle.get_output(0)[:x.shape[0]])
        wants.append(per_bucket)
    server = ModelServer(max_delay_ms=3.0, max_batch=8, dev_type='cpu')
    aot0 = t_instrument.counter_value('serving.sharded_aot_calls')
    traces0 = t_instrument.counter_value('compile.traces')
    server.load_model('tp', predictor=sp, input_shapes=dict(shapes))
    bad = []
    lock = threading.Lock()

    def client(idxs):
        for i in idxs:
            got = server.predict('tp', data=payloads[i], timeout=WAIT)[0]
            if not any(np.array_equal(got, w) for w in wants[i]):
                with lock:
                    bad.append(i)
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(k, len(payloads), 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not bad, 'responses diverged at payloads %s' % bad
        assert t_instrument.counter_value('serving.sharded_aot_calls') \
            - aot0 >= len(payloads) // 4
        assert t_instrument.counter_value('compile.traces') == traces0
        # float payloads: within rtol 1e-6 of the port's unsharded
        # forward (the same library); XLA and torch sum the 32- and
        # 64-term dots in other orders, so the JAX package's within 1e-5
        x = rng.rand(3, d_in).astype(np.float32)
        got = server.predict('tp', data=x, timeout=WAIT)[0]
        np.testing.assert_allclose(got, _slot_oracle(tlogits, x, dp),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, _slot_oracle(oracle, x, dp),
                                   rtol=1e-5, atol=1e-6)
    finally:
        server.close(drain=False, timeout=WAIT)


RESNET_KW = dict(units=[1, 1, 1, 1], num_stages=4,
                 filter_list=[8, 16, 32, 64, 128], num_classes=10,
                 image_shape=(3, 32, 32))
RESNET_SHAPE = (4, 3, 32, 32)


@pytest.fixture(scope='module')
def resnet():
    with jmx.base.NameManager():
        sym_json = j_resnet.resnet(**RESNET_KW).tojson()
    arg, aux = convert.random_params(tmx.sym.load_json(sym_json),
                                     {'data': RESNET_SHAPE}, seed=11)
    data = np.random.RandomState(12).randn(*RESNET_SHAPE).astype(np.float32)
    return sym_json, arg, aux, data


@pytest.mark.parametrize('mesh', ('1x2', '2x2'))
def test_narrow_resnet_sharded_against_jax(resnet, mesh, monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    sym_json, arg, aux, data = resnet
    dp, tp = _dims(mesh)
    params = {'arg:' + k: jmx.nd.array(v) for k, v in arg.items()}
    params.update({'aux:' + k: jmx.nd.array(v) for k, v in aux.items()})
    oracle = JaxPredictor(sym_json, params, {'data': RESNET_SHAPE},
                          pad_to_bucket=True)
    sp = Predictor(sym_json, convert.params_from_numpy(arg, aux, 'cpu'),
                   {'data': RESNET_SHAPE}, mesh=mesh, partition='auto',
                   devices=_cpus(dp * tp))
    recs = sp.sharding_records()['params']
    assert sum(1 for r in recs.values() if 'tp' in r['spec']) >= 10
    for rows in (1, 3, 4):
        sp.forward(data=data[:rows])
        got = sp.get_output(0)
        assert got.shape == (rows, 10)
        np.testing.assert_allclose(got, _slot_oracle(oracle, data[:rows],
                                                     dp),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('mesh', MESHES)
def test_records_equal_the_jax_package(mlp, mesh):
    sym_json, params, shapes, partition = mlp
    dp, tp = _dims(mesh)
    sp = _sharded(sym_json, params, shapes, mesh, partition)
    import jax
    jsp = JaxPredictor(sym_json, {k: jmx.nd.array(v)
                                  for k, v in params.items()},
                       dict(shapes), mesh=mesh, partition=partition,
                       devices=jax.devices()[:dp * tp])
    got = sp.sharding_records()
    assert got == jsp.sharding_records()
    mesh_free = jmesh.records_for_shapes(
        {n: r['shape'] for n, r in got['params'].items()}, mesh, partition)
    for name, rec in got['params'].items():
        want = mesh_free['params'][name]
        assert {k: rec[k] for k in ('shape', 'spec', 'shard_bytes',
                                    'reason')} == \
            {k: want[k] for k in ('shape', 'spec', 'shard_bytes', 'reason')}


def test_degradation_reasons_match(mlp):
    """``'auto'`` on a tp-indivisible tensor records its reason
    (``check_fleet.py:272-283``), in both packages alike."""
    import jax
    from mxnet_tpu import sym
    odd = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable('data'), num_hidden=63, name='ofc'), name='softmax')
    ash, _, _ = odd.infer_shape(data=(4, 31))
    rng = np.random.RandomState(5)
    op = {n: rng.randint(-1, 2, s).astype(np.float32)
          for n, s in zip(odd.list_arguments(), ash)
          if n not in ('data', 'softmax_label')}
    sp = Predictor(odd.tojson(), op, {'data': (4, 31)}, mesh='1x2',
                   partition='auto', devices=_cpus(2))
    jsp = JaxPredictor(odd.tojson(), {k: jmx.nd.array(v)
                                      for k, v in op.items()},
                       {'data': (4, 31)}, mesh='1x2', partition='auto',
                       devices=jax.devices()[:2])
    reasons = [(n, r['reason'])
               for n, r in sp.sharding_records()['params'].items()
               if r.get('reason')]
    assert reasons and 'no tp-divisible dim' in reasons[0][1]
    assert sp.sharding_records() == jsp.sharding_records()
    x = rng.randint(0, 3, (3, 31)).astype(np.float32)
    sp.forward(data=x)
    jsp.forward(data=x)
    np.testing.assert_allclose(sp.get_output(0), jsp.get_output(0),
                               rtol=1e-6, atol=1e-7)


def test_submesh_helpers_equal_the_jax_package():
    devs = list(range(8))
    for spec, slot in (('dp=1,tp=2', 0), ('dp=1,tp=2', 3), ('2x2', 1),
                       ('1x1', 7), ('4x2', 0)):
        assert tmesh.carve_submesh_devices(spec, slot, devs) == \
            jmesh.carve_submesh_devices(spec, slot, devs)
    for spec, slot in (('dp=1,tp=2', 4), ('4x4', 0)):
        msgs = []
        for m in (tmesh, jmesh):
            with pytest.raises(ValueError) as e:
                m.carve_submesh_devices(spec, slot, devs)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for spec in ('dp=1,tp=2', '4x2', '4x4', 3, '2x1'):
        assert tmesh.submesh_capacity(spec, devs) == \
            jmesh.submesh_capacity(spec, devs)
    for spec, by in (('4x2', 1), ({'dp': 3, 'tp': 1}, 2), ('2x2', 1)):
        assert tmesh.shrunk_spec(spec, by) == jmesh.shrunk_spec(spec, by)
    for m in (tmesh, jmesh):
        with pytest.raises(ValueError, match='would vanish'):
            m.shrunk_spec('1x2')
    plan = tmesh.ShardingPlan(tmesh.build_dp_tp_mesh('2x2', _cpus(4)))
    assert tmesh.shrunk_spec(plan) == {'dp': 1, 'tp': 2}
    assert not plan.multi_rank
    # the local device list: the CUDA devices, else the host's one
    n = torch.cuda.device_count()
    assert tmesh.local_devices() == (
        [tmx.gpu(i) for i in range(n)] if n else [tmx.cpu(0)])
    grid = tmesh.build_dp_tp_mesh('2x2', [tmx.cpu(0)] * 4)
    assert grid.position(1, 0) == tmx.cpu(0) and grid.size == 4
    with pytest.raises(ValueError, match='needs 4 devices'):
        tmesh.build_dp_tp_mesh('2x2', _cpus(3))


def _guard_messages(make):
    out = []
    sp = make()
    for call in (lambda: sp.reshape({'data': (4, 32)}),
                 lambda: sp.set_input('data', np.zeros((8, 32))),
                 lambda: sp.forward_exact(data=np.zeros((8, 32),
                                                        np.float32)),
                 lambda: sp.forward(data=np.zeros((2, 32), np.float32),
                                    bogus=np.zeros((2, 32))),
                 lambda: sp.forward(data=np.zeros((2, 32), np.float32),
                                    other=np.zeros((3, 32))),
                 lambda: make('3x1')):
        try:
            call()
        except Exception as e:      # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
        else:
            out.append(None)
    return out


def test_guards_and_dp_pow2_match_the_jax_package(mlp):
    import jax
    sym_json, params, shapes, partition = mlp

    def port(mesh='1x1'):
        dp, tp = _dims(mesh)
        return Predictor(sym_json, params, dict(shapes), mesh=mesh,
                         devices=_cpus(dp * tp))

    def jax_side(mesh='1x1'):
        dp, tp = _dims(mesh)
        return JaxPredictor(sym_json, {k: jmx.nd.array(v)
                                       for k, v in params.items()},
                            dict(shapes), mesh=mesh,
                            devices=jax.devices()[:dp * tp])
    got, want = _guard_messages(port), _guard_messages(jax_side)
    assert all(g is not None and g[0] == 'MXNetError' for g in got)
    assert got == want
    assert Predictor(sym_json, params, dict(shapes), mesh='1x1',
                     devices=_cpus(1)).sharding_records()['partition'] \
        == 'auto'


def test_gpu_sharded_predictor_raises_without_a_card(mlp):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is attached')
    sym_json, params, shapes, partition = mlp
    for kw in ({}, {'devices': [tmx.gpu(0)]}, {'devices': [tmx.cpu(0),
                                                          tmx.gpu(0)]}):
        with pytest.raises(tmx.MXNetError, match='CUDA device'):
            Predictor(sym_json, params, dict(shapes), mesh='1x%d'
                      % len(kw.get('devices', [0])), **kw)


def test_server_capacity_refused_scale_up_and_reload_keeps_mesh(mlp):
    """``tests/test_serving_fleet.py:321-348``: a partial reload keeps the
    stored mesh (and partition when not passed again); a sharded model's
    capacity is ``max(1, submesh_capacity(mesh))`` over the server's
    local devices (a CPU server's are ``[cpu(0)]``), and scale_up past
    it is refused."""
    sym_json, params, shapes, partition = mlp
    server = ModelServer(max_delay_ms=1, dev_type='cpu')
    jserver = j_serving.ModelServer(max_delay_ms=1)
    try:
        for srv, p in ((server, params),
                       (jserver, {k: jmx.nd.array(v)
                                  for k, v in params.items()})):
            srv.load_model('m', symbol_json=sym_json, params=p,
                           input_shapes=dict(shapes), mesh='1x1',
                           partition='replicated')
            srv.reload_model('m', symbol_json=sym_json, params=p,
                             partition='auto')
            kw = srv._entry('m').build_kw
            assert kw['mesh'] == '1x1' and kw['partition'] == 'auto'
            srv.reload_model('m', symbol_json=sym_json, params=p)
            assert srv._entry('m').build_kw['partition'] == 'auto'
        assert server.replica_capacity('m') == 1
        assert server.scale_up('m') is None
        assert server.replica_count('m') == 1
        assert server._entry('m').predictor._plan.sig() == \
            jserver._entry('m').predictor._plan.sig()
        x = np.random.RandomState(9).randint(0, 4, (3, 32)).astype(
            np.float32)
        np.testing.assert_allclose(
            server.predict('m', data=x, timeout=WAIT)[0],
            jserver.predict('m', data=x)[0], rtol=1e-6, atol=1e-7)
        # a 1x2 model: no disjoint pair in [cpu(0)], capacity still 1
        with pytest.raises(tmx.MXNetError, match='no disjoint device set'):
            server.load_model('wide', symbol_json=sym_json, params=params,
                              input_shapes=dict(shapes), mesh='1x2')
        server.load_model('wide', predictor=_sharded(
            sym_json, params, shapes, '1x2', partition),
            input_shapes=dict(shapes), mesh='1x2', partition=partition)
        assert server.replica_capacity('wide') == 1
        assert server.scale_up('wide') is None
    finally:
        server.close(drain=False, timeout=WAIT)
        jserver.close(drain=False)


class _SlowStub(object):
    """Predictor-shaped replica: ``2 * data[:, :1]`` after a 20 ms sleep
    (over a 5 ms SLO: every window breaches)."""

    def __init__(self):
        self._input_shapes = {'data': (8, 6)}
        self._batch_inputs = {'data'}
        self.num_outputs = 1
        self._out = None

    def forward(self, **kw):
        import time
        time.sleep(0.02)
        self._out = 2.0 * np.asarray(kw['data'], np.float32)[:, :1]

    def get_output(self, i):
        return self._out


def _at_capacity(serving, instrument, mesh, server_kw):
    """A sharded model at its device ceiling under a breaching window:
    the autoscaler takes the shrink relief, not a scale_up."""
    was = instrument.metrics_enabled()
    instrument.reset_metrics()
    instrument.set_metrics(True)
    server = serving.ModelServer(max_delay_ms=1, max_batch=8, **server_kw)
    try:
        server.load_model('s', predictor=_SlowStub(),
                          input_shapes={'data': (8, 6)}, mesh=mesh,
                          warm_start=False)
        sc = server.autoscale('s', slo_p99_ms=5.0, interval_s=0,
                              cooldown_s=0, start=False, up_after=1,
                              min_samples=3, max_replicas=3, min_batch=2)
        sc.async_actuation = False
        for _ in range(4):
            server.predict('s', data=np.ones((1, 6), np.float32),
                           timeout=WAIT)
        return {'capacity': server.replica_capacity('s'),
                'ticks': [{k: e[k] for k in ('action', 'replicas',
                                             'max_batch') if k in e}
                          for e in sc.tick()],
                'replicas': server.replica_count('s')}
    finally:
        server.close(drain=False)
        instrument.set_metrics(was)
        instrument.reset_metrics()


def test_autoscaler_takes_the_shrink_relief_at_a_sharded_ceiling():
    """Capacity 1 in both packages: ``'1x1'`` over the port's one CPU
    device, ``'1x8'`` over the JAX package's 8 virtual ones."""
    from mxnet_tpu import instrument as j_instrument
    from mxnet_tpu_torch import serving as t_serving
    got = _at_capacity(t_serving, t_instrument, '1x1', {'dev_type': 'cpu'})
    want = _at_capacity(j_serving, j_instrument, '1x8', {})
    assert got == want
    assert got['capacity'] == 1 and got['replicas'] == 1
    assert got['ticks'] == [{'action': 'shrink_batch', 'replicas': 1,
                             'max_batch': 4}]


def _sharded_repair(serving, instrument, resilience, mesh, server_kw):
    """A sharded model at capacity 1 whose worker dies: the supervisor's
    first scale_up finds no disjoint device set, so it detaches the dead
    worker and builds the replacement on the freed slot's devices."""
    was = instrument.metrics_enabled()
    instrument.reset_metrics()
    instrument.set_metrics(True)
    server = serving.ModelServer(max_delay_ms=0, **server_kw)
    built = []
    try:
        server.load_model('s', predictor=_SlowStub(),
                          input_shapes={'data': (8, 6)}, mesh=mesh,
                          warm_start=False)

        def build(slot=0, **kw):
            built.append((slot, kw.get('mesh')))
            return _SlowStub()
        server._build_predictor = build
        sup = server.supervise('s', wedge_ms=5000, interval_s=0,
                               start=False)
        batcher = server._entry('s').batcher
        resilience.set_faults('serve.worker.r0:after:1:kill')
        x = np.ones((1, 6), np.float32)
        server.predict('s', data=x, timeout=WAIT)
        batcher._workers[0].join(timeout=WAIT)
        events = [{k: e[k] for k in ('action', 'replica', 'why',
                                     'replacement', 'replicas') if k in e}
                  for e in sup.tick()]
        try:
            out = server.predict('s', data=x, timeout=WAIT)[0]
            served = out.ravel().tolist()
        except Exception as e:              # noqa: BLE001 - the outcome
            served = type(e).__name__
        return {'events': events, 'built_slots': [b[0] for b in built],
                'replicas': [r.rid for r in server._entry('s').replicas],
                'served': served}
    finally:
        resilience.clear_faults()
        server.close(drain=False)
        instrument.set_metrics(was)
        instrument.reset_metrics()


def test_supervisor_replaces_a_sharded_replica_on_its_own_slot():
    """Both packages build the replacement on the dead replica's own slot
    (its devices); the reference's detach of the last worker stops its
    batcher, so its replacement cannot attach and the model sheds
    (ROADMAP Queue 3).  The port keeps admission open across the retry,
    and the replacement serves."""
    from mxnet_tpu import instrument as j_instrument
    from mxnet_tpu import resilience as j_resilience
    from mxnet_tpu_torch import resilience as t_resilience
    from mxnet_tpu_torch import serving as t_serving
    got = _sharded_repair(t_serving, t_instrument, t_resilience, '1x1',
                          {'dev_type': 'cpu'})
    ref = _sharded_repair(j_serving, j_instrument, j_resilience, '1x8', {})
    assert got['built_slots'] == ref['built_slots'] == [0]
    assert got == {'events': [{'action': 'quarantine', 'replica': 0,
                               'why': 'dead'},
                              {'action': 'replace', 'replica': 0,
                               'replacement': 0, 'replicas': 1}],
                   'built_slots': [0], 'replicas': [0], 'served': [2.0]}
    assert ref['served'] == 'MXNetError'
