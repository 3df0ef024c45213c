"""The chronicle plane of the PyTorch port (``chronicle.py``) against the
JAX package on the CPU, and ``Module.fit`` with all four observability
planes on in both packages.

The same registry contents, sampled at the same scripted times, give
the same journal records in both packages (counters as ``[total, delta,
rate]``, gauges, cumulative histogram buckets), the same windowed
queries and the same detector verdicts; rotation keeps the ring bound;
the sampler thread starts and stops with a bounded join.  The whole
slice: the narrow ResNet v2 through ``Module.fit`` with
``MXTPU_HEALTH_SENTINELS``, ``MXTPU_PERFWATCH``, ``MXTPU_IOWATCH`` and
``MXTPU_CHRONICLE`` in both packages trains the same parameters (rtol
1e-4, as tests/test_torch_train.py), reports the same health values and
goodput bucket schema, and journals samples."""
import json
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import chronicle as j_chronicle
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import chronicle as t_chronicle
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch.models import resnet as tresnet

from test_torch_health import reset_planes

CHRON = {'jax': j_chronicle, 'torch': t_chronicle}
PKGS = {'jax': mx, 'torch': tmx}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ('MXTPU_CHRONICLE', 'MXTPU_PERFWATCH', 'MXTPU_IOWATCH',
              'MXTPU_HEALTH_SENTINELS', 'MXTPU_HEALTH_ACTION'):
        monkeypatch.delenv(k, raising=False)
    saved = []
    for pkg in (mx, tmx):
        ins = pkg.instrument
        saved.append((ins, ins.metrics_enabled(), list(ins._decisions),
                      dict(ins._decision_seq), dict(ins._decision_last_t),
                      list(ins._decision_sinks)))
        ins._decisions[:] = []
        ins._decision_seq.clear()
        ins._decision_last_t.clear()
        ins._decision_sinks[:] = []
        ins.reset_metrics()
        ins.set_metrics(True)
    reset_planes()
    yield
    reset_planes()
    for ins, met, dec, seq, last, sinks in saved:
        ins._decisions[:] = dec
        ins._decision_seq.clear()
        ins._decision_seq.update(seq)
        ins._decision_last_t.clear()
        ins._decision_last_t.update(last)
        ins._decision_sinks[:] = sinks
        ins.set_metrics(met)
        ins.reset_metrics()


def _records(jdir):
    out = []
    for name in sorted(os.listdir(jdir)):
        if name.startswith('journal-'):
            with open(os.path.join(jdir, name)) as f:
                out.extend(json.loads(line) for line in f if line.strip())
    return out


def _feed(name, tmp_path, detectors=None):
    """The same registry writes and samples at t = 100, 102, ..."""
    ins = PKGS[name].instrument
    c = CHRON[name].Chronicle(str(tmp_path / name), every_ms=100,
                              detectors=detectors or {})
    recs = []
    for i in range(6):
        ins.inc('work.items', 10 * i)
        ins.set_gauge('work.depth', 3.5 + i)
        ins.observe_hist('work.secs', 0.01 * (i + 1))
        recs.append(c.sample(now=100.0 + 2 * i))
    c.close()
    return c, recs


def test_journal_sample_format_matches_jax(tmp_path):
    got = {}
    for name in ('jax', 'torch'):
        c, recs = _feed(name, tmp_path)
        on_disk = [r for r in _records(c.dir) if r['kind'] == 'sample']
        assert on_disk == json.loads(json.dumps(recs))
        got[name] = on_disk
    assert got['torch'] == got['jax']
    assert got['torch'][-1]['counters']['work.items'] == [150, 50, 25.0]


def test_query_matches_jax(tmp_path):
    out = {}
    for name in ('jax', 'torch'):
        c, _ = _feed(name, tmp_path)
        out[name] = {s: c.query(s, 6.0, now=110.0)
                     for s in ('work.depth', 'work.items', 'work.secs',
                               'absent')}
    assert out['torch'] == out['jax']
    assert out['torch']['absent'] == {}
    assert out['torch']['work.depth']['slope'] == pytest.approx(0.5)


def _verdicts(name, tmp_path):
    """A throughput sag and recovery, and a leak, through the stock
    detectors."""
    ins = PKGS[name].instrument
    c = CHRON[name].Chronicle(str(tmp_path / name), every_ms=100,
                              detectors=CHRON[name].default_detectors())
    for i in range(80):
        sps = 20.0 if 30 <= i < 34 else 100.0 + (i % 3)
        ins.set_gauge('perf.steps_per_sec', sps)
        ins.set_gauge('goodput.fraction', 0.9)
        ins.set_gauge('mem.live_bytes', 1e9 * (1.0 + 0.05 * max(0, i - 40)))
        c.sample(now=1000.0 + i)
    c.close()
    evs = ins.recent_decisions(subsystem='chronicle')
    pms = sorted(n for n in os.listdir(c.dir) if n.endswith('-anomaly.json'))
    return {'events': [(e['action'], e.get('series')) for e in evs],
            'postmortems': pms,
            'count': ins.metrics_snapshot()['counters'].get(
                'chronicle.anomalies')}


def test_detector_verdicts_match_jax(tmp_path):
    got = {n: _verdicts(n, tmp_path) for n in ('jax', 'torch')}
    assert got['torch'] == got['jax']
    events = got['torch']['events']
    assert ('anomaly', 'perf.steps_per_sec') in events
    assert ('anomaly_cleared', 'perf.steps_per_sec') in events
    assert ('anomaly', 'mem.live_bytes') in events


def test_rotation_and_ring_bound(tmp_path):
    c = t_chronicle.Chronicle(str(tmp_path / 'j'), every_ms=100,
                              detectors={},
                              max_mb=2048 / (1024.0 * 1024.0))
    tmx.instrument.set_gauge('g', 1.0)
    for i in range(400):
        c.sample(now=1000.0 + i)
    c.close()
    names = os.listdir(c.dir)
    assert any(n != t_chronicle.ACTIVE_NAME and n.startswith('journal-')
               for n in names)
    total = sum(os.path.getsize(os.path.join(c.dir, n)) for n in names
                if n.startswith('journal-'))
    assert total <= c.max_bytes + c.seg_bytes
    snap = tmx.instrument.metrics_snapshot()['counters']
    assert snap['chronicle.rotations'] >= 1
    assert snap['chronicle.segments_dropped'] >= 1


def test_thread_decisions_and_off_by_default(tmp_path):
    """Off: no thread, query {}.  start(): the sampler thread journals
    samples and every decision event; stop() joins it (bounded)."""
    assert not t_chronicle.enabled() and t_chronicle.query('x', 10) == {}
    assert not any(t.name == t_chronicle.THREAD_NAME
                   for t in threading.enumerate())
    tmx.instrument.set_metrics(False)
    c = t_chronicle.start(str(tmp_path / 'live'), every_ms=10)
    assert c is t_chronicle.active() and tmx.instrument.metrics_enabled()
    tmx.instrument.decision('health', 'warn', reason='test')
    deadline = 200
    while deadline and not any(r['kind'] == 'sample'
                               for r in _records(c.dir)):
        threading.Event().wait(0.02)
        deadline -= 1
    t_chronicle.stop()
    assert not any(t.name == t_chronicle.THREAD_NAME
                   for t in threading.enumerate())
    kinds = {r['kind'] for r in _records(c.dir)}
    assert kinds == {'sample', 'decision'}


def _narrow_resnet(res):
    return res.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[8, 16, 32, 64, 128], num_classes=10,
                      image_shape=(3, 64, 64))


def test_fit_with_all_four_planes_matches_jax(monkeypatch, tmp_path):
    """The whole slice, in both packages: sentinels, perfwatch, iowatch
    and the chronicle on around Module.fit of the narrow ResNet v2
    (sentinels under warn; the sampler every 10 ms)."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    monkeypatch.setenv('MXTPU_PERFWATCH', '1')
    monkeypatch.setenv('MXTPU_IOWATCH', '1')
    monkeypatch.setenv('MXTPU_CHRONICLE_EVERY_MS', '10')
    batch, steps = 4, 3
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    out, params = {}, {}
    iow = {'jax': j_iowatch, 'torch': t_iowatch}
    pw = {'jax': j_perfwatch, 'torch': t_perfwatch}
    for name, pkg in PKGS.items():
        jdir = str(tmp_path / name)
        monkeypatch.setenv('MXTPU_CHRONICLE', jdir)
        if name == 'jax':
            # the JAX package reads the knob at import; the port's fit
            # reads it again (chronicle.refresh)
            j_chronicle.start(jdir)
        m = pkg.mod.Module(pkg.sym.load_json(tsym.tojson()),
                           context=pkg.cpu())
        m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
              optimizer='sgd',
              optimizer_params={'learning_rate': 0.05, 'momentum': 0.9,
                                'wd': 1e-4},
              arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
              aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
        CHRON[name].stop()
        snap = pkg.instrument.metrics_snapshot()
        gp = iow[name].goodput_snapshot()
        params[name] = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
        out[name] = {
            'health': {k: snap['gauges'][k] for k in
                       ('health.steps', 'health.action_level')},
            'nan_steps': snap['counters'].get('health.nan_steps'),
            'buckets': sorted(gp['buckets']),
            'fit_rows': [r['kind'] for r in pw[name].executables()],
            'mfu': snap['gauges']['perf.mfu'] > 0,
            'samples': any(r['kind'] == 'sample' for r in _records(jdir))}
        total = gp['productive_secs'] + sum(gp['buckets'].values())
        assert total == pytest.approx(gp['wall_secs'], rel=1e-6)
    assert out['torch'] == out['jax']
    assert out['torch']['health'] == {'health.steps': steps,
                                      'health.action_level': 0}
    assert out['torch']['samples'] and out['torch']['fit_rows'] == \
        ['fit_step']
    for k, v in params['jax'].items():
        np.testing.assert_allclose(params['torch'][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
