"""The port's in-process kvstore (``mxnet_tpu_torch/kvstore.py``) against
the JAX package's, on the CPU: the eight cases of ``tests/test_kvstore.py``
run in both packages on the same values, and the pulled arrays must be
equal exactly (sums and an SGD step of small integers and 0.1 are exact
in float32 in any order).  The JAX side's per-device values sit on four
of its eight CPU devices; the port's on ``cpu(0)..cpu(3)`` (one torch
device, four contexts).  Also: a demoted store refuses its data plane
but keeps its barrier, ``create`` picks the classes, the
``kvstore.pushes/pulls/*_bytes`` counters, and ``RetryPolicy`` gives the
reference's delay sequence for the same seed."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import resilience as jres
from mxnet_tpu_torch import instrument as tinst
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import resilience as tres

SHAPE = (4, 4)
KEYS = [5, 7, 11]
NUM_DEVS = 4


class _Pkg(object):
    """What a case needs of one package."""

    def __init__(self, jax_side):
        self.jax = jax_side
        self.m = mx if jax_side else tmx
        self.kv = jkv if jax_side else tkv

    def dev(self, i):
        return self.m.cpu(i)

    def ones(self, ctx=None):
        if self.jax:
            return mx.nd.ones(SHAPE, ctx) if ctx else mx.nd.ones(SHAPE)
        with tmx.cpu():
            return tmx.nd.ones(SHAPE, ctx)

    def zeros(self, ctx=None):
        return self.m.nd.zeros(SHAPE, ctx)

    def init_kv(self, kind='local'):
        kv = self.kv.create(kind)
        kv.init(3, self.zeros())
        kv.init(KEYS, [self.zeros()] * len(KEYS))
        return kv


def _np(a):
    return np.asarray(a.asnumpy())


def case_single_kv_pair(p):
    kv = p.init_kv()
    kv.push(3, p.ones())
    val = p.zeros()
    kv.pull(3, out=val)
    return [_np(val)]


def case_list_kv_pair(p):
    kv = p.init_kv()
    kv.push(KEYS, [p.ones() * 4] * len(KEYS))
    val = [p.zeros() for _ in KEYS]
    kv.pull(KEYS, out=val)
    return [_np(v) for v in val]


def case_aggregator(p):
    kv = p.init_kv()
    devs = [p.dev(i) for i in range(NUM_DEVS)]
    kv.push(3, [p.ones(d) for d in devs])
    out = [p.zeros(d) for d in devs]
    kv.pull(3, out=out)
    got = [_np(v) for v in out]
    kv.push(KEYS, [[p.ones(d) * 2.0 for d in devs] for _ in KEYS])
    outs = [[p.zeros(d) for d in devs] for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return got + [_np(v) for o in outs for v in o]


def case_updater(p):
    kv = p.init_kv()

    def updater(key, recv, local):
        local += recv
    kv.set_updater(updater)
    vals = [p.ones(p.dev(i)) for i in range(NUM_DEVS)]
    kv.push(3, vals)
    kv.push(3, vals)
    val = p.zeros()
    kv.pull(3, out=val)
    return [_np(val)]


def case_optimizer_on_kvstore(p):
    kv = p.init_kv()
    kv.set_optimizer(p.m.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    kv.push(3, p.ones())
    val = p.zeros()
    kv.pull(3, out=val)
    return [_np(val)]


def case_get_type_and_factory(p):
    kv = p.kv.create('dist_sync')
    kv.barrier()
    return [np.array([p.kv.create('local').type == 'local',
                      p.kv.create('device').type == 'device',
                      kv.rank, kv.num_workers], np.float32)]


def case_duplicate_init_raises(p):
    kv = p.init_kv()
    with pytest.raises(Exception):
        kv.init(3, p.zeros())
    return [np.zeros(1)]


def case_optimizer_states_save_load(p, tmp_path):
    kv = p.init_kv()
    kv.set_optimizer(p.m.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       rescale_grad=1.0))
    kv.push(3, p.ones())
    f = str(tmp_path / ('states_jax' if p.jax else 'states_port'))
    kv.save_optimizer_states(f)
    kv.load_optimizer_states(f)
    kv.push(3, p.ones())
    val = p.zeros()
    kv.pull(3, out=val)
    return [_np(val)]


CASES = [case_single_kv_pair, case_list_kv_pair, case_aggregator,
         case_updater, case_optimizer_on_kvstore, case_get_type_and_factory,
         case_duplicate_init_raises, case_optimizer_states_save_load]


@pytest.mark.parametrize('case', CASES, ids=[c.__name__[5:] for c in CASES])
def test_kvstore_case_matches_jax_exactly(case, tmp_path):
    args = (tmp_path,) if case is case_optimizer_states_save_load else ()
    want = case(_Pkg(True), *args)
    got = case(_Pkg(False), *args)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), (w, g)


def test_port_store_states_load_in_the_next_store(tmp_path):
    """The momentum state saved by one store carries into another: the
    second push after the load moves by lr * (momentum * 1 + 1)."""
    p = _Pkg(False)
    kv = p.init_kv()
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       rescale_grad=1.0))
    kv.push(3, p.ones())
    f = str(tmp_path / 's')
    kv.save_optimizer_states(f)
    kv2 = p.init_kv()
    kv2.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                        rescale_grad=1.0))
    kv2.load_optimizer_states(f)
    kv2.push(3, p.ones())
    val = p.zeros()
    kv2.pull(3, out=val)
    np.testing.assert_allclose(val.asnumpy(), -0.19, rtol=1e-6)


def test_pull_writes_into_the_bound_tensor():
    """A pull copies into the output's own tensor: an executor bound to it
    reads the new values without a rebind."""
    p = _Pkg(False)
    kv = p.init_kv()
    kv.push(3, p.ones() * 3)
    out = p.zeros()
    handle = out.handle
    kv.pull(3, out=out)
    assert out.handle is handle and float(handle.sum()) == 48.0


def test_demoted_store_refuses_its_data_plane():
    before = tinst.counter_value('kvstore.demotions')
    for pkg in (_Pkg(True), _Pkg(False)):
        kv = pkg.init_kv()
        kv.demote_to_control_plane()
        assert kv.control_plane_only
        with pytest.raises(Exception, match='control-plane'):
            kv.push(3, pkg.ones())
        with pytest.raises(Exception, match='control-plane'):
            kv.pull(3, out=pkg.zeros())
        kv.barrier()                    # the control plane stays
    if tinst.metrics_enabled():
        assert tinst.counter_value('kvstore.demotions') == before + 1


def test_transfer_counters_count_calls_and_bytes():
    tinst.set_metrics(True)
    p = _Pkg(False)
    kv = p.init_kv()
    c0 = {k: tinst.counter_value('kvstore.' + k)
          for k in ('pushes', 'pulls', 'push_bytes', 'pull_bytes')}
    kv.push(KEYS, [[p.ones(p.dev(i)) for i in range(2)] for _ in KEYS])
    kv.pull(KEYS, out=[p.zeros() for _ in KEYS])
    d = {k: tinst.counter_value('kvstore.' + k) - c0[k] for k in c0}
    assert d == {'pushes': 1, 'pulls': 1,
                 'push_bytes': 3 * 2 * 16 * 4, 'pull_bytes': 3 * 16 * 4}


def test_create_picks_the_classes():
    assert type(tkv.create('local')) is tkv.KVStore
    assert type(tkv.create('dist_sync')) is tkv.DistKVStore
    assert type(tkv.create('dist_device_sync')) is tkv.DistKVStore
    with pytest.raises(TypeError):
        tkv.create(3)


@pytest.mark.parametrize('seed', [0, 7, 123])
def test_retry_policy_delays_match_the_reference(seed):
    kw = dict(base=0.05, multiplier=2.0, max_delay=2.0, jitter=0.25,
              seed=seed)
    j, t = jres.RetryPolicy(**kw), tres.RetryPolicy(**kw)
    assert [j.delay(a) for a in range(12)] == \
        [t.delay(a) for a in range(12)]


def test_retry_policy_run_retries_until_it_returns_or_runs_out():
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError('down')
        return 'up'
    pol = tres.RetryPolicy(base=0.001, max_delay=0.002, jitter=0.0, seed=1)
    assert pol.run(flaky, on_retry=lambda a, e: seen.append(a)) == 'up'
    assert seen == [0, 1]
    capped = tres.RetryPolicy(base=0.001, max_delay=0.002, max_retries=1)
    with pytest.raises(ConnectionError):
        capped.run(lambda: (_ for _ in ()).throw(ConnectionError('x')))
    late = tres.RetryPolicy(base=0.5, max_delay=0.5, deadline=0.1)
    with pytest.raises(ConnectionError):
        late.run(lambda: (_ for _ in ()).throw(ConnectionError('x')))


def test_retry_policy_from_env_reads_the_kv_knobs(monkeypatch):
    monkeypatch.setenv('MXTPU_KV_RETRY_BASE', '0.2')
    monkeypatch.setenv('MXTPU_KV_RETRY_MAX', '3.0')
    monkeypatch.setenv('MXTPU_KV_RETRY_JITTER', '0')
    monkeypatch.setenv('MXTPU_KV_OP_DEADLINE', '9')
    pol = tres.RetryPolicy.from_env(seed=3)
    ref = jres.RetryPolicy.from_env(seed=3)
    assert (pol.base, pol.max_delay, pol.jitter, pol.deadline) == \
        (0.2, 3.0, 0.0, 9.0)
    assert [pol.delay(a) for a in range(6)] == \
        [ref.delay(a) for a in range(6)]
