"""The serving fleet's attribution plane against the JAX package:
servewatch (request ids, the six-bucket exclusive chain, flush
composition, exemplars, capped slow/error/shed/replayed/deadline
postmortems), the span plane and its Chrome trace, the windowed and
merged histogram reads, Prometheus rendering and the flight recorder,
run through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU.

The cases follow the reference's own (``tests/test_servewatch.py``,
``tests/test_instrument.py`` spans / windows / labeled exposition,
``tests/test_health.py`` flight recorder round trip,
``tests/test_serving_resilience.py`` drain through the recorder and the
replayed / deadline postmortems).  Request ids and clocks differ between
the packages, so each scenario returns what must agree: chain
exactness, flush composition, postmortem kinds and payload keys,
counters, and ``render_prometheus``'s text on the same snapshot dict,
which must be byte for byte the same.  The port's dumped trace passes
``tools/check_trace.py``.  The off path is checked structurally (no ids,
nothing recorded, no threads), not by wall-clock ratios.  Every
``result()``, ``join()`` and ``wait()`` takes a timeout.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import health as j_health
from mxnet_tpu import instrument as j_instrument
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import resilience as j_resilience
from mxnet_tpu import serving as j_serving
from mxnet_tpu.serving import servewatch as j_servewatch
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import instrument as t_instrument
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import resilience as t_resilience
from mxnet_tpu_torch import serving as t_serving
from mxnet_tpu_torch.serving import servewatch as t_servewatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import check_trace  # noqa: E402

JAX = SimpleNamespace(name='jax', serving=j_serving, sw=j_servewatch,
                      health=j_health, instrument=j_instrument,
                      resilience=j_resilience, server_kw={})
TORCH = SimpleNamespace(name='torch', serving=t_serving, sw=t_servewatch,
                        health=t_health, instrument=t_instrument,
                        resilience=t_resilience,
                        server_kw={'dev_type': 'cpu'})
WAIT = 30            # seconds: the bound on every wait in this file
SHAPES = {'data': (8, 6)}
X = np.zeros((1, 6), np.float32)


def _reset(pkg):
    pkg.sw.set_slow_ms(0.0)
    pkg.sw.set_enabled(False)
    pkg.sw.set_postmortem_cap(64)
    pkg.sw.reset()
    pkg.health._recorder = None
    pkg.instrument.clear_trace()
    pkg.resilience.clear_faults()


@pytest.fixture(autouse=True)
def _plane_on(monkeypatch):
    """Servewatch on with metrics; every process-global toggle, ring and
    recorder is left as found.  Both packages' goodput ledgers (a fit
    run earlier in this process leaves its snapshot, which flight
    records embed) are out of the way for the test."""
    monkeypatch.setattr(j_iowatch, '_ledger', None)
    monkeypatch.setattr(j_iowatch, '_last_snapshot', None)
    monkeypatch.setattr(t_iowatch, '_ledger', None)
    monkeypatch.setattr(t_iowatch, '_last_snapshot', None)
    was = [(p, p.instrument.profiling_enabled(),
            p.instrument.metrics_enabled()) for p in (JAX, TORCH)]
    for p, _, _ in was:
        _reset(p)
        p.instrument.reset_metrics()
        p.instrument.set_metrics(True)
        p.sw.set_enabled(True)
    yield
    for p, prof, met in was:
        _reset(p)
        p.instrument.set_profiling(prof)
        p.instrument.set_metrics(met)
        p.instrument.reset_metrics()


def _both(scenario, *a):
    """Run ``scenario(pkg, *a)`` on each package; the outcomes must be
    equal.  Returns the port's."""
    got = {p.name: scenario(p, *a) for p in (JAX, TORCH)}
    assert got['torch'] == got['jax']
    return got['torch']


class _Stub(object):
    """Predictor-shaped replica with the ``_active_bucket`` hook real
    Predictors expose: ``out = 2 * data[:, :1]`` after ``service_s``;
    ``fail`` raises; with ``gate`` set a forward waits on it (bounded)
    after announcing itself on ``entered``."""

    def __init__(self, service_s=0.0, fail=False):
        self._input_shapes = dict(SHAPES)
        self._batch_inputs = {'data'}
        self.num_outputs = 1
        self.service_s = service_s
        self.fail = fail
        self.on_forward = None
        self.gate = None
        self.entered = threading.Event()
        self._out = None

    def forward(self, **kw):
        rows = kw['data'].shape[0]
        self._active_bucket = 1 << max(0, rows - 1).bit_length()
        self.entered.set()
        if self.on_forward:
            self.on_forward()
        if self.gate is not None:
            self.gate.wait(timeout=WAIT)
        if self.fail:
            raise RuntimeError('injected forward failure')
        if self.service_s:
            time.sleep(self.service_s)
        self._out = 2.0 * np.asarray(kw['data'], np.float32)[:, :1]

    def get_output(self, i):
        return self._out


def _server(pkg, service_s=0.0, fail=False, **kw):
    stub = _Stub(service_s=service_s, fail=fail)
    server = pkg.serving.ModelServer(**pkg.server_kw, **kw)
    server.load_model('w', predictor=stub, input_shapes=dict(SHAPES),
                      warm_start=False)
    return server, stub


def _payload(path):
    with open(path) as f:
        doc = json.load(f)
    return doc, doc[doc['reason']]


# ---------------------------------------------------------------------------
# The ledger: exclusive buckets sum to e2e exactly
# ---------------------------------------------------------------------------

def _chains(pkg, tmp):
    pkg.instrument.set_profiling(True)
    server, _ = _server(pkg, service_s=0.003, max_delay_ms=2)
    try:
        futs = [server.submit('w', data=X + i) for i in range(6)]
        for f in futs:
            f.result(timeout=WAIT)
        rids = [f.req_id for f in futs]
    finally:
        server.close(drain=False, timeout=WAIT)
    events = pkg.instrument.trace_events()
    reqs = {}
    for e in events:
        args = e.get('args') or {}
        if e['name'].startswith('serve.req.'):
            reqs.setdefault(args['req'], {})[
                e['name'][len('serve.req.'):]] = e['dur']
        elif e['name'] == 'serve.request':
            reqs.setdefault(args['req'], {})['e2e'] = e['dur']
    out = {'ids': all(r and r.startswith('w-') for r in rids)
           and len(set(rids)) == 6,
           'traced': set(reqs) == set(rids),
           'exact': all(sum(s[b] for b in pkg.sw.BUCKETS) == s['e2e']
                        for s in reqs.values()),
           'buckets': sorted({b for s in reqs.values() for b in s}),
           'flush_spans': any(e['name'] == 'serve.flush' for e in events),
           'flush_span_named': any(e['name'] == 'serving.flush[w]'
                                   for e in events),
           'valid': check_trace.validate_events(events)}
    path = os.path.join(tmp, '%s.json' % pkg.name)
    pkg.instrument.dump_trace(path)
    out['file_valid'] = check_trace.validate_file(path)
    if pkg is TORCH:
        out['cli'] = subprocess.call(
            [sys.executable, os.path.join(REPO, 'tools', 'check_trace.py'),
             path], timeout=WAIT)
    else:
        out['cli'] = 0
    return out


def test_request_spans_telescope_to_e2e_exactly(tmp_path):
    out = _both(_chains, str(tmp_path))
    assert out == {'ids': True, 'traced': True, 'exact': True,
                   'buckets': sorted(t_servewatch.BUCKETS + ('e2e',)),
                   'flush_spans': True, 'flush_span_named': True,
                   'valid': [], 'file_valid': [], 'cli': 0}


def _budget(pkg):
    server, _ = _server(pkg, service_s=0.002, max_delay_ms=1)
    try:
        for _ in range(8):
            server.predict('w', data=X, timeout=WAIT)
        tables = pkg.sw.budget_tables()
    finally:
        server.close(drain=False, timeout=WAIT)
    return {key: (t['e2e']['count'], sorted(t),
                  abs(sum(t[b]['sum'] for b in pkg.sw.BUCKETS)
                      - t['e2e']['sum']) <= 1e-9 * t['e2e']['sum'])
            for key, t in tables.items()}


def test_budget_tables_ledger_is_exclusive():
    out = _both(_budget)
    assert out == {('w', 'batch', '0'): (
        8, sorted(t_servewatch.BUCKETS + ('e2e',)), True)}


def _composition(pkg):
    server, _ = _server(pkg, max_delay_ms=20)
    try:
        server.pause('w')
        futs = [server.submit('w', data=X) for _ in range(3)]
        server.resume('w')
        for f in futs:
            f.result(timeout=WAIT)
        rids = {f.req_id for f in futs}
        fl = [f for f in pkg.sw.flushes() if rids & set(f['req_ids'])]
        return {'flushes': len(fl), 'peers': set(fl[0]['req_ids']) == rids,
                'rows': fl[0]['rows'], 'bucket': fl[0]['bucket'],
                'pad_waste': fl[0]['pad_waste'], 'sig': fl[0]['sig'],
                'replica': fl[0]['replica'], 'lane': fl[0]['lane'],
                'keys': sorted(fl[0])}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_flush_composition_names_peers_bucket_waste_and_sig():
    out = _both(_composition)
    assert out['flushes'] == 1 and out['peers']
    assert (out['rows'], out['bucket'], out['pad_waste']) == (3, 4, 1)
    assert out['sig'] == '_Stub[b=4]'
    assert (out['replica'], out['lane']) == (0, 'batch')


# ---------------------------------------------------------------------------
# Exemplars and Prometheus
# ---------------------------------------------------------------------------

def _exemplars(pkg):
    server, _ = _server(pkg, max_delay_ms=1)
    try:
        futs = [server.submit('w', data=X) for _ in range(4)]
        for f in futs:
            f.result(timeout=WAIT)
        last = futs[-1].req_id
        snap = pkg.instrument.metrics_snapshot()
    finally:
        server.close(drain=False, timeout=WAIT)
    e2e = {k: h for k, h in snap['histograms'].items()
           if k.startswith(('serving.req.e2e_secs|', 'serving.e2e_secs'))}
    out = {'series': sorted(e2e),
           'last_in': all(last in {ex[1] for ex in h['exemplars']}
                          for h in e2e.values())}
    prom = pkg.instrument.render_prometheus(snap)
    out['exemplar_lines'] = sum(1 for line in prom.splitlines()
                                if '# {request_id="w-' in line) > 0
    pkg.instrument.observe_hist('plain_secs', 0.001)
    prom = pkg.instrument.render_prometheus()
    plain = [line for line in prom.splitlines()
             if line.startswith('mxtpu_plain_secs_bucket')]
    out['plain_clean'] = bool(plain) and not [
        line for line in plain if '#' in line.split('}', 1)[1]]
    return out


def test_exemplars_in_snapshot_and_prometheus():
    assert _both(_exemplars) == {
        'series': ['serving.e2e_secs',
                   'serving.e2e_secs|lane=batch,model=w,replica=0',
                   'serving.req.e2e_secs|lane=batch,model=w,replica=0'],
        'last_in': True, 'exemplar_lines': True, 'plain_clean': True}


SNAPSHOT = {
    'counters': {'serving.requests': 12, 'metric.host_syncs': 3,
                 'srv.flushes|model=clf,replica=0': 3,
                 'srv.flushes|model=clf,replica=1': 5,
                 '9lives': 1},
    'gauges': {'srv.replicas|model=clf': 2, 'mem.frac': 0.25,
               'odd': float('nan'), 'up': float('inf'),
               'esc|model=a"b\\c\nd': 1},
    'timers': {'fit.step': {'total_sec': 1.5, 'count': 3,
                            'avg_sec': 0.5}},
    'histograms': {
        'serving.e2e_secs|lane=batch,model=clf,replica=0': {
            'count': 3, 'sum': 0.111, 'p50': 0.01, 'p95': 0.1,
            'p99': 0.1,
            'buckets': [[0.0031622776601683794, 1], [0.01, 2],
                        [0.1, 3]],
            'exemplars': [[0.01, 'clf-7', 0.01], [0.1, 'clf-9', 0.1]]},
        'big': {'count': 1, 'sum': 1e6, 'buckets': [['+Inf', 1]]},
        'empty': {}}}


def _render(pkg):
    ins = pkg.instrument
    seen = set()
    out = [ins.render_prometheus(SNAPSHOT),
           ins.render_prometheus(SNAPSHOT, labels={'rank': 3},
                                 seen_types=seen),
           ins.render_prometheus(SNAPSHOT, labels={'rank': 4},
                                 seen_types=seen),
           ins.render_prometheus(SNAPSHOT, timestamp_ms=1700000000123),
           ins.render_prometheus({})]
    # the live registry after the same observations renders the same
    ins.inc('srv.flushes|model=clf,replica=0', 3)
    ins.inc('srv.flushes|model=clf,replica=1', 5)
    ins.observe_hist('srv.lat|model=clf,replica=1', 0.01)
    ins.observe_hist('srv.lat|model=clf,replica=1', 0.5, exemplar='clf-3')
    ins.set_gauge('srv.replicas|model=clf', 2)
    with ins.timed('t.region'):
        pass
    live = ins.metrics_snapshot()
    live['timers']['t.region'] = {'total_sec': 0.0, 'count': 1,
                                  'avg_sec': 0.0}
    out.append(ins.render_prometheus(live, labels={'rank': 0}))
    out.append(ins.split_labeled_name('a.b|model=m,replica=2'))
    out.append(ins.split_labeled_name('plain'))
    return out


def test_render_prometheus_gives_the_same_text():
    out = _both(_render)
    lines = out[1].splitlines()
    assert 'mxtpu_srv_flushes_total{model="clf",rank="3",replica="0"} 3' \
        in lines
    assert out[1].count('# TYPE mxtpu_srv_flushes_total counter') == 1
    assert out[2].count('# TYPE') == 0
    assert ('mxtpu_serving_e2e_secs_bucket{lane="batch",le="0.1",'
            'model="clf",replica="0"} 3 # {request_id="clf-9"} 0.1') \
        in out[0].splitlines()
    assert out[4] == ''
    assert out[-2] == ('a.b', {'model': 'm', 'replica': '2'})


# ---------------------------------------------------------------------------
# Spans, windows and merges
# ---------------------------------------------------------------------------

def test_span_nesting_and_trace_schema(tmp_path):
    ins = t_instrument
    ins.set_profiling(True)

    def worker():
        with ins.span('thread_work', cat='test'):
            time.sleep(0.001)

    t = threading.Thread(target=worker, name='producer')
    with ins.span('outer', cat='test'):
        t.start()
        t.join(timeout=WAIT)
        with ins.span('inner', cat='test', args={'k': 1}):
            time.sleep(0.001)

    @ins.instrumented(cat='test')
    def work(x):
        return x + 1
    assert work(1) == 2
    path = str(tmp_path / 'trace.json')
    assert ins.dump_trace(path) == 4
    with open(path) as f:
        doc = json.load(f)
    assert doc['displayTimeUnit'] == 'ms'
    by_name = {e['name']: e for e in doc['traceEvents']
               if e.get('ph') != 'M'}
    outer, inner = by_name['outer'], by_name['inner']
    assert inner['tid'] == outer['tid'] != by_name['thread_work']['tid']
    assert outer['ts'] <= inner['ts']
    assert inner['ts'] + inner['dur'] <= outer['ts'] + outer['dur']
    assert inner['args'] == {'k': 1}
    assert any(n.endswith('work') for n in by_name)
    meta = {(e['name'], e['args']['name']) for e in doc['traceEvents']
            if e.get('ph') == 'M'}
    assert ('process_name', 'mxnet_tpu_torch') in meta
    assert ('thread_name', 'producer') in meta
    assert check_trace.validate_file(path) == []
    # drained: nothing left; off: nothing recorded
    assert ins.trace_events() == []
    ins.set_profiling(False)
    with ins.span('off'):
        pass
    assert work(2) == 3 and ins.trace_events() == []


def _windows(pkg):
    ins = pkg.instrument
    for _ in range(200):
        ins.observe_hist('win', 1.0)
    prev = ins.histogram('win').snapshot()
    for _ in range(100):
        ins.observe_hist('win', 0.001)
    cur = ins.histogram('win').snapshot()
    d = ins.hist_delta(cur, prev)
    out = {'delta': (d['count'], round(d['sum'], 9), d['p99'] < 0.01,
                     cur['p99'] > 0.5),
           'full': ins.hist_delta(cur, None) == ins.hist_delta(cur),
           'reset_clamps': ins.hist_delta(prev, cur)['count']}
    for v in (0.001, 0.002):
        ins.observe_hist('m.lat|replica=0', v)
    for v in (1.0, 2.0):
        ins.observe_hist('m.lat|replica=1', v)
    merged = ins.hist_merge([ins.histogram('m.lat|replica=%d' % r)
                             .snapshot() for r in (0, 1)])
    out['merged'] = merged
    out['merge_empty'] = ins.hist_merge([])['count']
    win, other = ins.HistogramWindow(), ins.HistogramWindow()
    ins.observe_hist('w.lat', 0.01)
    out['per_consumer'] = (win.delta('w.lat')['count'],
                           win.delta('w.lat')['count'],
                           other.delta('w.lat')['count'])
    ins.observe_hist('w.lat|model=a,replica=0', 0.01)
    ins.observe_hist('w.lat|model=a,replica=1', 0.02)
    names = win.peek_names('w.lat|')
    out['names'] = names
    out['merged_delta'] = win.merged_delta(names)['count']
    out['missing'] = (win.delta('w.nothere')['count'],
                      'w.nothere' in ins.metrics_snapshot().get(
                          'histograms', {}))
    ins.observe_hist('big', 1e6)
    h = ins.histogram('big')
    out['overflow'] = (h.counts[-1], h.snapshot()['buckets'],
                       ins.histogram('none').quantile(0.99))
    ins.inc('c', 2)
    ins.set_gauge('g', 1.5)
    ins.observe('t', 0.25)
    ins.observe('t', 0.75)
    snap = ins.metrics_snapshot()
    out['kinds'] = (snap['counters']['c'], snap['gauges']['g'],
                    snap['timers']['t'], ins.counter('c').value,
                    ins.timer('t').avg)
    out['type_clash'] = _raises(lambda: ins.gauge('c'))
    ins.set_metrics(False)
    ins.inc('c')
    ins.observe_hist('win', 1.0)
    with ins.timed('t'):
        pass
    out['off'] = (ins.counter_value('c'), ins.histogram('win').count,
                  ins.timer('t').count)
    ins.set_metrics(True)
    return out


def _raises(call):
    try:
        call()
    except Exception as e:                 # noqa: BLE001 - the outcome
        return type(e).__name__
    return None


def test_hist_delta_merge_and_windows_per_consumer():
    out = _both(_windows)
    assert out['delta'] == (100, 0.1, True, True)
    assert out['full'] and out['reset_clamps'] == 0
    assert out['merged']['count'] == 4 and out['merged']['p99'] > 0.5
    assert out['per_consumer'] == (1, 0, 1)
    assert out['names'] == ['w.lat|model=a,replica=0',
                            'w.lat|model=a,replica=1']
    assert out['merged_delta'] == 2 and out['missing'] == (0, False)
    assert out['type_clash'] == 'TypeError'
    assert out['off'] == (2, 300, 2)


def test_profiling_implies_metrics_and_releases_them():
    def scenario(pkg):
        ins = pkg.instrument
        ins.set_metrics(False)
        ins.set_profiling(True)
        on = ins.metrics_enabled()
        ins.set_profiling(False)
        released = ins.metrics_enabled()
        ins.set_metrics(True)
        ins.set_profiling(True)
        ins.set_profiling(False)
        return (on, released, ins.metrics_enabled())
    assert _both(scenario) == (True, False, True)


# ---------------------------------------------------------------------------
# Postmortems
# ---------------------------------------------------------------------------

def _slow(pkg, tmp):
    pkg.health.install_flight_recorder(os.path.join(tmp, pkg.name))
    pkg.sw.set_slow_ms(5.0)
    server, stub = _server(pkg, service_s=0.02, max_delay_ms=1)
    # an autoscaler decision fired mid-request lands in its window
    stub.on_forward = lambda: pkg.sw.note_decision(
        {'t': time.time(), 'model': 'w', 'action': 'scale_up',
         'reason': 'test'})
    try:
        server.predict('w', data=X, timeout=WAIT)
    finally:
        server.close(drain=False, timeout=WAIT)
    pms = pkg.sw.postmortems()
    out = {'kinds': [p['kind'] for p in pms],
           'dominant': [p['dominant'] for p in pms],
           'exists': all(p['path'] and os.path.exists(p['path'])
                         for p in pms)}
    doc, payload = _payload(pms[0]['path'])
    out['doc_keys'] = sorted(k for k in doc if k != doc['reason'])
    out['payload_keys'] = sorted(payload)
    out['same_id'] = payload['req_id'] == pms[0]['req_id']
    out['slow_ms'] = payload['slow_ms']
    out['sums'] = abs(sum(payload['buckets_ms'][b] for b in pkg.sw.BUCKETS)
                      - payload['e2e_ms']) <= 1e-6 * payload['e2e_ms']
    out['execute_ms'] = payload['buckets_ms']['execute'] >= 15.0
    out['decision_in_window'] = [e['action'] for e in
                                 payload['autoscaler_events']]
    out['lookup'] = pkg.sw.postmortem_for(payload['req_id']) == pms[0]
    out['counters'] = {k: pkg.instrument.counter_value(k) for k in (
        'serving.postmortems', 'serving.postmortems_dropped',
        'health.flight_dumps')}
    return out


def test_slow_postmortem_is_durable_and_names_the_wait(tmp_path):
    out = _both(_slow, str(tmp_path))
    assert out['kinds'] == ['slow'] and out['dominant'] == ['execute']
    assert out['exists'] and out['same_id'] and out['sums']
    assert out['execute_ms'] and out['slow_ms'] == 5.0
    assert out['decision_in_window'] == ['scale_up'] and out['lookup']
    assert out['counters'] == {'serving.postmortems': 1,
                               'serving.postmortems_dropped': 0,
                               'health.flight_dumps': 1}


def _error_shed_cap(pkg):
    server, _ = _server(pkg, fail=True, max_delay_ms=1)
    try:
        err = _raises(lambda: server.predict('w', data=X, timeout=WAIT))
    finally:
        server.close(drain=False, timeout=WAIT)
    out = {'error': err, 'kinds': [p['kind'] for p in
                                   pkg.sw.postmortems()],
           'req_hists': [k for k in pkg.instrument.metrics_snapshot()
                         .get('histograms', {})
                         if k.startswith('serving.req.')]}
    server, _ = _server(pkg, max_delay_ms=1000, max_queue=1)
    try:
        server.pause('w')
        server.submit('w', data=X)
        out['shed'] = _raises(lambda: server.submit('w', data=X))
    finally:
        server.close(drain=False, timeout=WAIT)
    out['kinds_after_shed'] = [p['kind'] for p in pkg.sw.postmortems()]
    # no recorder installed: the registry entry stays, with no path
    out['paths'] = [p['path'] for p in pkg.sw.postmortems()]
    pkg.sw.reset()
    pkg.sw.set_postmortem_cap(1)
    pkg.sw.set_slow_ms(0.5)
    server, _ = _server(pkg, service_s=0.005, max_delay_ms=1)
    try:
        for _ in range(3):
            server.predict('w', data=X, timeout=WAIT)
    finally:
        server.close(drain=False, timeout=WAIT)
    out['capped'] = len(pkg.sw.postmortems())
    c = pkg.instrument.metrics_snapshot()['counters']
    out['dropped'] = c.get('serving.postmortems_dropped', 0)
    out['skipped'] = c.get('serving.postmortems_skipped', 0)
    return out


def test_error_shed_postmortems_and_the_cap():
    out = _both(_error_shed_cap)
    assert out['error'] == 'RuntimeError' and out['kinds'] == ['error']
    assert out['req_hists'] == []        # errors stay out of the SLO series
    assert out['shed'] == 'ServerOverloadedError'
    assert out['kinds_after_shed'] == ['error', 'shed']
    assert out['paths'] == [None, None]
    assert out['capped'] == 1 and out['dropped'] == 2


def _off_path(pkg):
    pkg.sw.set_enabled(False)
    before = set(threading.enumerate())
    pkg.sw.set_enabled(True)
    pkg.sw.refresh()                     # the env says off
    pkg.sw.set_enabled(True)
    out = {'threads': set(threading.enumerate()) == before}
    pkg.sw.set_enabled(False)
    server, _ = _server(pkg, max_delay_ms=1)
    try:
        fut = server.submit('w', data=X)
        fut.result(timeout=WAIT)
        out['req_id'] = getattr(fut, 'req_id', None)
    finally:
        server.close(drain=False, timeout=WAIT)
    snap = pkg.instrument.metrics_snapshot()
    out['req_hists'] = [k for k in snap.get('histograms', {})
                        if k.startswith('serving.req.')]
    out['exemplars'] = [k for k, h in snap.get('histograms', {}).items()
                        if h.get('exemplars')]
    out['rings'] = (pkg.sw.flushes(), pkg.sw.postmortems(),
                    pkg.sw.decisions())
    return out


def test_disabled_plane_records_nothing_and_starts_no_threads():
    assert _both(_off_path) == {'threads': True, 'req_id': None,
                                'req_hists': [], 'exemplars': [],
                                'rings': ([], [], [])}


# ---------------------------------------------------------------------------
# The flight recorder and the serving drain through it
# ---------------------------------------------------------------------------

def _roundtrip(pkg, tmp):
    ins = pkg.instrument
    rec = pkg.health.FlightRecorder(os.path.join(tmp, pkg.name), ring=128,
                                    every=3)
    dropped0 = ins.dropped_totals()      # cumulative over the process
    ins.set_profiling(True)
    ins.inc('health.test_counter', 5)
    for i in range(10):
        with ins.span('flight_span_%d' % i, cat='test'):
            pass
    ins.decision('test', 'poke', reason='roundtrip')
    path = rec.dump('unit-test')
    with open(path) as f:
        doc = json.load(f)
    out = {'keys': sorted(doc), 'schema': doc['schema'],
           'reason': doc['reason'], 'health': doc['health'],
           'spans': 'flight_span_9' in {e['name'] for e in doc['spans']},
           'counter': doc['metrics']['counters']['health.test_counter'],
           'decisions': [d['action'] for d in doc['decisions']][-1:],
           'dropped': doc['dropped_events'] - dropped0,
           'not_drained': any(e['name'] == 'flight_span_0'
                              for e in ins.trace_events())}
    rec.tick()
    rec.tick()
    os.remove(path)
    rec.tick()
    out['every_third'] = os.path.exists(path)
    out['durable'] = os.path.basename(rec.durable_path('serve-w/1 x'))
    rec.dump('serve-x', extra={'k': 1})
    out['durable_written'] = _payload(rec.durable_path('serve-x'))[1]
    return out


def test_flight_recorder_dump_roundtrip(tmp_path):
    out = _both(_roundtrip, str(tmp_path))
    assert out['keys'] == ['decisions', 'drains', 'dropped_events',
                           'health', 'metrics', 'pid', 'rank', 'reason',
                           'schema', 'spans', 'time']
    assert out['schema'] == 'mxtpu-flight-recorder-1' and \
        out['health'] == {}
    assert out['spans'] and out['counter'] == 5 and out['not_drained']
    assert out['decisions'] == ['poke'] and out['every_third']
    assert out['durable'] == 'flightrec-rank0-serve-w_1_x.json'
    assert out['durable_written'] == {'k': 1}


def _drain(pkg, tmp):
    pkg.health.install_flight_recorder(os.path.join(tmp, pkg.name))
    server, _ = _server(pkg, max_delay_ms=1)
    sup = server.supervise('w', wedge_ms=5000, interval_s=0, start=False)
    sc = server.autoscale('w', slo_p99_ms=1000.0, interval_s=0,
                          start=False)
    for _ in range(3):
        server.predict('w', data=X, timeout=WAIT)
    snap = server.drain(timeout=5.0, reason='test')
    _, payload = _payload(snap['flight_path'])
    return {'keys': sorted(snap), 'servewatch': sorted(snap['servewatch']),
            'flushes': len(snap['servewatch']['flushes']),
            'requests': snap['stats']['counters']['serving.requests'],
            'file': os.path.basename(snap['flight_path']),
            'payload_models': payload['models'],
            'same': (sup is not None, sc is not None),
            'after': _raises(lambda: server.predict('w', data=X)),
            'drains': pkg.instrument.counter_value('serving.drains')}


def test_server_drain_commits_snapshot_through_flight_recorder(tmp_path):
    assert _both(_drain, str(tmp_path)) == {
        'keys': ['autoscaler_events', 'drain_secs', 'flight_path',
                 'models', 'reason', 'servewatch', 'stats',
                 'supervisor_events'],
        'servewatch': ['decisions', 'flushes', 'postmortems',
                       'supervision'],
        'flushes': 3, 'requests': 3,
        'file': 'flightrec-rank0-serve-test.json',
        'payload_models': ['w'], 'same': (True, True),
        'after': 'ModelNotFoundError', 'drains': 1}


def _replayed(pkg, tmp):
    pkg.health.install_flight_recorder(os.path.join(tmp, pkg.name))
    stubs = [_Stub() for _ in range(4)]
    server = pkg.serving.ModelServer(**pkg.server_kw, max_delay_ms=0,
                                     max_batch=1)
    server.load_model('w', predictor=stubs[0], input_shapes=dict(SHAPES),
                      warm_start=False)
    server._build_predictor = lambda slot=0, **kw: stubs[slot]
    server.scale_up('w')
    gate = threading.Event()
    try:
        sup = server.supervise('w', wedge_ms=0, interval_s=0, start=False)
        gate1 = threading.Event()
        stubs[0].gate, stubs[1].gate = gate, gate1
        stubs[0].entered.clear()
        stubs[1].entered.clear()
        server.pause('w')
        futs = [server.submit('w', data=X + v) for v in (1.0, 2.0)]
        server.resume('w')
        assert stubs[0].entered.wait(WAIT) and stubs[1].entered.wait(WAIT)
        gate1.set()
        concurrent.futures.wait(
            futs, timeout=WAIT,
            return_when=concurrent.futures.FIRST_COMPLETED)
        actions = [e['action'] for e in sup.tick()]
        responses = sorted(f.result(timeout=WAIT)[0].ravel().tolist()
                           for f in futs)
        pms = [p for p in pkg.sw.postmortems() if p['kind'] == 'replayed']
        _, payload = _payload(pms[0]['path'])
        return {'actions': actions, 'responses': responses,
                'ring': [e['action'] for e in pkg.sw.supervision_events()],
                'replayed': len(pms), 'flag': payload['replayed'],
                'quarantine': (payload['quarantine']['action'],
                               payload['quarantine']['replica']),
                'state': payload['supervision']['state'].get('0'),
                'buckets': sorted(payload['buckets_ms'])}
    finally:
        gate.set()
        server.close(drain=False, timeout=WAIT)


def test_replayed_request_postmortem_names_the_quarantine(tmp_path):
    out = _both(_replayed, str(tmp_path))
    assert out['actions'] == ['quarantine', 'replay', 'replace']
    assert out['responses'] == [[2.0], [4.0]]
    assert out['ring'] == ['quarantine', 'replay', 'replace']
    assert out['replayed'] == 1 and out['flag'] is True
    assert out['quarantine'] == ('quarantine', 0)
    assert out['state'] == 'quarantined'


def _deadline(pkg, tmp):
    pkg.health.install_flight_recorder(os.path.join(tmp, pkg.name))
    server, _ = _server(pkg, max_delay_ms=1)
    try:
        server.pause('w')
        fut = server.submit('w', deadline_ms=25.0, data=X)
        time.sleep(0.05)
        server.resume('w')
        err = _raises(lambda: fut.result(timeout=WAIT))
        pms = [p for p in pkg.sw.postmortems() if p['kind'] == 'deadline']
        _, payload = _payload(pms[0]['path'])
        return {'error': err, 'deadlines': len(pms),
                'deadline_ms': round(payload['deadline_ms'], 6),
                'waited': payload['waited_ms'] >= payload['deadline_ms'],
                'keys': sorted(payload),
                'req_hists': [k for k in pkg.instrument.metrics_snapshot()
                              .get('histograms', {})
                              if k.startswith('serving.req.')]}
    finally:
        server.close(drain=False, timeout=WAIT)


def test_deadline_drop_postmortem(tmp_path):
    out = _both(_deadline, str(tmp_path))
    assert out['error'] == 'DeadlineExceededError' and out['deadlines'] == 1
    assert out['deadline_ms'] == 25.0 and out['waited']
    assert {'supervision', 'admission', 'quarantine'} <= set(out['keys'])
    assert out['req_hists'] == []
