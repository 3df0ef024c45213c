"""The input-pipeline & goodput plane of the PyTorch port (``iowatch.py``)
against the JAX package on the CPU: the same event sequence, on one
scripted clock, gives the same goodput buckets, events and fraction in
both; the same batches give the same throughput counters; a real
``Module.fit`` keeps the ledger's identity (productive + buckets = wall)
and charges one ``metric_drain`` event per counted host sync; the fit
loop, ``BucketSentenceIter`` and the flight recorder carry the plane's
calls; off, nothing of it appears."""
import json
import threading
import types

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import health as j_health
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import iowatch as t_iowatch

from test_torch_health import reset_planes

IOW = {'jax': j_iowatch, 'torch': t_iowatch}
PKGS = {'jax': mx, 'torch': tmx}
# the counter each package's traced_dispatch watches
TRACE_COUNTER = {'jax': 'executor.xla_traces', 'torch': 'compile.traces'}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ('MXTPU_IOWATCH', 'MXTPU_HEALTH_SENTINELS',
              'MXTPU_HEALTH_ACTION', 'MXTPU_PERFWATCH'):
        monkeypatch.delenv(k, raising=False)
    met = [(p.instrument, p.instrument.metrics_enabled()) for p in (mx, tmx)]
    reset_planes()
    for ins, _ in met:
        ins.reset_metrics()
        ins.set_metrics(True)
    yield
    reset_planes()
    for ins, m in met:
        ins.set_metrics(m)
        ins.reset_metrics()


class _Clock(object):
    """A scripted ``time.monotonic``."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def _script(name, monkeypatch):
    """One fit's worth of ledger events on a scripted clock."""
    iow, ins = IOW[name], PKGS[name].instrument
    clock = _Clock()
    monkeypatch.setattr(iow, 'time', types.SimpleNamespace(
        monotonic=clock.monotonic))
    iow.set_enabled(True)
    iow.goodput_begin()
    clock.t += 1.0                                  # productive
    with iow.account('input_stall'):
        clock.t += 0.5
    with iow.account('barrier'):
        clock.t += 0.25
        with iow.account('checkpoint'):             # pauses barrier
            clock.t += 0.75
        clock.t += 0.125
    with iow.account('eval'):                       # sticky: absorbs
        clock.t += 0.5
        with iow.account('input_stall'):
            clock.t += 0.25
    with iow.traced_dispatch():                     # no capture
        clock.t += 2.0
    with iow.traced_dispatch():                     # a capture
        with iow.account('compile'):
            clock.t += 0.375
        ins.inc(TRACE_COUNTER[name])
        clock.t += 1.5
    with iow.account('metric_drain'):
        clock.t += 0.0625
    mon = HEALTH[name].HealthMonitor('skip_update')
    mon.steps, mon.nan_steps = 10, 2
    iow.note_health(mon)
    clock.t += 0.5
    return iow.goodput_end()


HEALTH = {'jax': j_health, 'torch': t_health}


def test_event_sequence_matches_jax(monkeypatch):
    got = {n: _script(n, monkeypatch) for n in ('jax', 'torch')}
    assert got['torch'] == got['jax']
    snap = got['torch']
    assert sorted(snap['buckets']) == sorted(t_iowatch.BUCKETS)
    assert snap['buckets']['compile'] == pytest.approx(1.875)
    assert snap['buckets']['eval'] == pytest.approx(0.75)
    assert snap['buckets']['health_skipped'] > 0
    total = snap['productive_secs'] + sum(snap['buckets'].values())
    assert total == pytest.approx(snap['wall_secs'], abs=1e-9)
    gauges = tmx.instrument.metrics_snapshot()['gauges']
    assert gauges['goodput.fraction'] == pytest.approx(snap['fraction'])


def test_note_batch_counts_match_jax():
    """The same delivered batches give the same iowatch counters."""
    x = np.arange(6 * 5, dtype=np.float32).reshape(6, 5)
    y = np.arange(6, dtype=np.float32)
    out = {}
    for name, pkg in PKGS.items():
        IOW[name].set_enabled(True)
        for b in pkg.io.NDArrayIter(x, y, batch_size=4):   # 2, one padded
            pass
        c = pkg.instrument.metrics_snapshot()['counters']
        out[name] = {k: c.get(k) for k in ('io.batches', 'iowatch.batches',
                                           'iowatch.samples',
                                           'iowatch.bytes')}
    assert out['torch'] == out['jax']
    assert out['torch']['iowatch.samples'] == 6


def test_nested_fit_cannot_clobber_live_ledger(monkeypatch):
    monkeypatch.setenv('MXTPU_IOWATCH', '1')
    outer = t_iowatch.activate_fit()
    assert outer is not None and t_iowatch.goodput_ledger() is outer
    assert t_iowatch.activate_fit() is None
    t_iowatch.goodput_end(t_iowatch.GoodputLedger())
    assert t_iowatch.goodput_ledger() is outer
    assert t_iowatch.goodput_end(outer) and \
        t_iowatch.goodput_ledger() is None


def test_non_owner_thread_is_noop():
    t_iowatch.set_enabled(True)
    t_iowatch.goodput_begin()

    def producer():
        with t_iowatch.account('input_stall'):
            pass
        t_iowatch.charge('recovery', 99.0)

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=30)
    snap = t_iowatch.goodput_end()
    assert snap['buckets']['input_stall'] == 0.0
    assert snap['buckets']['recovery'] == 0.0


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=16,
                                 name='ifc1')
    net = pkg.sym.Activation(net, act_type='relu', name='iact1')
    net = pkg.sym.FullyConnected(net, num_hidden=4, name='ifc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _fit(pkg, monkeypatch, env, nbatch=8, bs=16, num_epoch=2):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(0)
    X = rng.randn(nbatch * bs, 10).astype(np.float32)
    Y = (X @ rng.randn(10, 4)).argmax(1).astype(np.float32)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=bs), num_epoch=num_epoch,
            optimizer_params={'learning_rate': 0.1},
            initializer=pkg.init.Uniform(0.05),
            batch_end_callback=[pkg.callback.Speedometer(bs, 3)])
    return mod


def test_fit_buckets_sum_to_wall_and_drains_match_syncs(monkeypatch):
    """A real fit in each package: the full bucket schema, productive +
    buckets = wall, goodput.* published, and one metric_drain event per
    counted host sync (the same counts in both packages)."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.instrument.reset_metrics()
        _fit(pkg, monkeypatch, {'MXTPU_IOWATCH': '1'})
        gp = IOW[name].goodput_snapshot()
        c = pkg.instrument.metrics_snapshot()['counters']
        total = gp['productive_secs'] + sum(gp['buckets'].values())
        assert total == pytest.approx(gp['wall_secs'], rel=1e-6)
        assert 0.0 < gp['fraction'] <= 1.0
        g = pkg.instrument.metrics_snapshot()['gauges']
        assert all('goodput.%s_secs' % b in g for b in IOW[name].BUCKETS)
        out[name] = {'buckets': sorted(gp['buckets']),
                     'drain_events': gp['events']['metric_drain'],
                     'syncs': c.get('metric.host_syncs'),
                     'batches': c.get('iowatch.batches'),
                     'input_events': gp['events']['input_stall'] > 0}
    assert out['torch'] == out['jax']
    assert out['torch']['drain_events'] == out['torch']['syncs'] > 0


def test_off_by_default_zero_surface(monkeypatch):
    assert not t_iowatch.enabled()
    assert t_iowatch.stage('read') is t_iowatch.account('barrier')
    _fit(tmx, monkeypatch, {}, nbatch=4, num_epoch=1)
    snap = tmx.instrument.metrics_snapshot()
    assert not any(k.startswith(('iowatch.', 'goodput.'))
                   for section in ('counters', 'gauges', 'histograms')
                   for k in snap.get(section, {}))
    assert t_iowatch.goodput_snapshot() == {}


def test_flight_record_carries_goodput(tmp_path):
    t_iowatch.set_enabled(True)
    t_iowatch.goodput_begin()
    with t_iowatch.account('checkpoint'):
        pass
    path = t_health.FlightRecorder(str(tmp_path), ring=16).dump('test')
    with open(path) as f:
        doc = json.load(f)
    assert sorted(doc['goodput']['buckets']) == sorted(t_iowatch.BUCKETS)
    t_iowatch.goodput_end()


def test_bucket_sentence_iter_notes_batches():
    """BucketSentenceIter.next counts io.batches and notes each batch
    with the plane, as the JAX iterator does."""
    sents = [[1, 2, 3, 4], [2, 3, 4, 5, 6], [1, 2], [3, 4, 5], [2, 2, 2]]
    out = {}
    for name, pkg in PKGS.items():
        IOW[name].set_enabled(True)
        it = pkg.rnn.BucketSentenceIter(sents, batch_size=1,
                                        buckets=[3, 6], invalid_label=0)
        n = sum(1 for _ in it)
        c = pkg.instrument.metrics_snapshot()['counters']
        out[name] = (n, c.get('io.batches'), c.get('iowatch.batches'),
                     c.get('iowatch.samples'))
    assert out['torch'] == out['jax'] and out['torch'][0] > 0
