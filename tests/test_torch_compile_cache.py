"""Warm starts across processes in the PyTorch port
(``compile_cache``: the warmup manifest, the warm-ups, the cubin
store; ``Module._warm_start`` / ``BucketingModule._warm_start``;
``perfwatch``'s ``step_cost`` rows) against the JAX package on the CPU.

The manifest's record / dedup / reload / cap behaviour and ``jsonable``
give the reference's documents fed the same calls; a tiny MLP ``fit``
with ``MXTPU_COMPILE_CACHE`` writes the same ``fit_step`` entries (fp,
meta, batch) in both packages, exactly; with the knob unset nothing is
made (no directory, no file, no thread); ``warmup`` counts
``compile.warmup_traces`` instead of ``compile.traces``; ``_warm_start``
on a manifest with an extra signature schedules the reference's
signature keys, and warms each on the calling thread before the first
batch, so a fit that drains its metric and reads and sets its
parameters between batches ends where a cold fit does; a cold and a warm child process (120 s bound each) end
with bit-for-bit equal parameters, the warm one having warmed the
signature only the manifest named; the cubin store's key, its atomic
write and a cut file counted as a miss (NVRTC stubbed: there is none
here).  The JAX package's persistent cache is not switched on here: its
manifest is installed directly, so JAX's own compilation cache stays
untouched."""
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import compile_cache as jcc
from mxnet_tpu import health as j_health
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import compile_cache as tcc
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import instrument as tins
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch import rtc as trtc

KNOBS = ('MXTPU_COMPILE_CACHE', 'MXTPU_WARM_START', 'MXTPU_PERFWATCH',
         'MXTPU_IOWATCH', 'MXTPU_HEALTH_SENTINELS', 'MXTPU_FUSE',
         'MXTPU_PRECOMPILE_BUCKETS')
OPT = {'learning_rate': 0.1, 'momentum': 0.9}


def reset_planes():
    """Both packages' process-global plane state back to off, and both
    packages' compile caches uninstalled."""
    for h in (j_health, t_health):
        h.deactivate()
        h._recorder = None
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
    for cc in (jcc, tcc):
        cc._cache_dir = None
        cc._manifest = None


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    reset_planes()
    for pkg in (mx, tmx):
        pkg.instrument.reset_metrics()
        pkg.instrument.set_metrics(True)
    yield
    reset_planes()


@contextlib.contextmanager
def _reference_manifest(path):
    """The JAX package's manifest at ``path``, installed without its
    persistent-cache half."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jcc._cache_dir = os.path.dirname(path)
    jcc._manifest = jcc._Manifest(path)
    try:
        yield
    finally:
        jcc._cache_dir = None
        jcc._manifest = None


def _mlp(pkg, hidden=8, classes=3):
    net = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(net, num_hidden=hidden, name='fc1')
    net = pkg.sym.Activation(net, act_type='relu', name='act1')
    net = pkg.sym.FullyConnected(net, num_hidden=classes, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _data(n=8, d=5, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _params(seed=1, d=5, hidden=8, classes=3):
    rng = np.random.RandomState(seed)
    return {'fc1_weight': rng.randn(hidden, d).astype(np.float32) * 0.3,
            'fc1_bias': np.zeros(hidden, np.float32),
            'fc2_weight': rng.randn(classes, hidden).astype(np.float32) * 0.3,
            'fc2_bias': np.zeros(classes, np.float32)}


# ---------------------------------------------------------------------------
# The manifest, fed the same calls
# ---------------------------------------------------------------------------

_CALLS = [
    {'kind': 'fit_step', 'fp': 'a', 'meta': {'metric': ('m', 'Acc'),
                                            'compute_dtype': None},
     'batch': {'data': [[4, 5], 'float32']}},
    {'kind': 'forward', 'fp': 'b', 'meta': {'is_train': False}},
    {'kind': 'fit_step', 'fp': 'a', 'meta': {'metric': ['m', 'Acc'],
                                            'compute_dtype': None},
     'batch': {'data': [[4, 5], 'float32']}},          # a duplicate
    {'kind': 'step_cost', 'program': 'fit_step', 'key': 'k', 'flops': 1.5,
     'num_devices': 1},
    {'kind': 'fit_step', 'fp': 'a', 'meta': {}, 'batch': {
        'data': [(2, 5), 'float32'], 'label': [(2,), np.dtype('int32')]}},
]


@pytest.mark.parametrize('cap', [512, 3])
def test_manifest_matches_the_reference_fed_the_same_calls(tmp_path,
                                                           monkeypatch, cap):
    """record / dedup / the cap / the committed document / a reload by a
    fresh instance give the same results and files in both packages."""
    docs, results = {}, {}
    for name, cc in (('jax', jcc), ('torch', tcc)):
        monkeypatch.setattr(cc, 'MANIFEST_CAP', cap)
        path = str(tmp_path / name / 'manifest.json')
        os.makedirs(os.path.dirname(path))
        m = cc._Manifest(path)
        results[name] = [m.record(cc.jsonable(c)) for c in _CALLS]
        with open(path) as f:
            docs[name] = json.load(f)
        again = cc._Manifest(path)
        results[name].append([again.entries(), again.entries('fit_step', 'a'),
                              again.record(cc.jsonable(_CALLS[0]))])
    assert results['torch'] == results['jax']
    assert docs['torch'] == docs['jax']
    assert len(docs['torch']['traces']) == min(cap, 4)


@pytest.mark.parametrize('value', [
    (1, 2.5, 'a', None, True), {'k': (1, [2, (3,)]), 3: 'x'},
    np.dtype('float32'), [torch.float32]])
def test_jsonable_matches_the_reference(value):
    got = tcc.jsonable(value)
    if isinstance(value, list) and value and isinstance(value[0],
                                                        torch.dtype):
        assert got == ['torch.float32']
        return
    assert got == jcc.jsonable(value)


def test_record_entry_and_entries_without_a_directory():
    assert tcc.cache_dir() is None and tcc.manifest_path() is None
    assert tcc.record_entry({'kind': 'x'}) is False
    assert tcc.manifest_entries() == []


# ---------------------------------------------------------------------------
# A fit writes the reference's fit_step entries
# ---------------------------------------------------------------------------

def _fit(pkg, x, y, batch=4, epochs=1, **kw):
    m = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=epochs,
          optimizer='sgd', optimizer_params=OPT, eval_metric='acc',
          arg_params={k: pkg.nd.array(v) for k, v in _params().items()},
          **kw)
    return m


def test_fit_writes_the_reference_fit_step_entries(tmp_path, monkeypatch):
    x, y = _data()
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path / 'torch'))
    _fit(tmx, x, y)
    assert tcc.cache_dir() == str(tmp_path / 'torch')
    with _reference_manifest(str(tmp_path / 'jax' / 'manifest.json')):
        _fit(mx, x, y)
        want = jcc.manifest_entries('fit_step')
    got = tcc.manifest_entries('fit_step')
    assert got == want and len(got) == 1
    assert got[0]['meta'] == {'metric': ['mxnet_tpu.metric', 'Accuracy'],
                              'compute_dtype': None, 'health': None,
                              'mesh': None}
    assert got[0]['batch'] == {'data': [[4, 5], 'float32'],
                               'softmax_label': [[4], 'float32']}
    assert tins.metrics_snapshot()['gauges'][
        'compile.manifest_entries'] >= 1


def test_knobs_off_install_nothing(tmp_path, monkeypatch):
    """No MXTPU_COMPILE_CACHE: a warm-started fit creates no directory,
    no file and no thread, and records nothing."""
    import threading
    monkeypatch.chdir(tmp_path)
    x, y = _data()
    before = set(threading.enumerate())
    _fit(tmx, x, y, warm_start=True)
    assert tcc.cache_dir() is None and tcc._manifest is None
    assert not [t for t in set(threading.enumerate()) - before
                if 'warm' in t.name]
    assert os.listdir(str(tmp_path)) == []
    assert tins.counter_value('compile.warmup_traces') == 0


# ---------------------------------------------------------------------------
# Warm-ups
# ---------------------------------------------------------------------------

def test_warmup_counts_warmup_traces():
    """A capture inside warmup() counts compile.warmup_traces (not
    compile.traces), on the calling thread; its seconds go to
    compile.warmup_secs; what the warm-up raises, warmup() raises."""
    import threading
    before = tins.counter_value('compile.traces')
    ran = []
    assert tcc.warmup('t', lambda: (tins.count_trace(),
                                    ran.append(threading.get_ident()),
                                    7)[2]) == 7
    assert ran == [threading.get_ident()]
    tins.count_trace()                      # a capture of the hot path
    snap = tins.metrics_snapshot()
    assert tins.counter_value('compile.warmup_traces') == 1
    assert tins.counter_value('compile.traces') == before + 1
    assert snap['histograms']['compile.warmup_secs']['count'] == 1
    with pytest.raises(ZeroDivisionError):
        tcc.warmup('t', lambda: 1 / 0)
    assert tins.counter_value('compile.warmup_traces') == 1
    tins.count_trace()
    assert tins.counter_value('compile.traces') == before + 2


def _bound_module(pkg, batch=4):
    m = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    m.bind(data_shapes=[('data', (batch, 5))],
           label_shapes=[('softmax_label', (batch,))])
    m.init_params(arg_params={k: pkg.nd.array(v)
                              for k, v in _params().items()})
    m.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    return m


def test_warm_start_schedules_the_reference_signature_keys(tmp_path,
                                                           monkeypatch):
    """A manifest naming the bound signature, a 2-row one (a short last
    batch), one of another meta and one of another fingerprint: both
    packages' _warm_start schedule the same two keys; the port's job
    for the 2-row signature builds its step over batch buffers of its
    own."""
    meta = {'metric': ['mxnet_tpu.metric', 'Accuracy'],
            'compute_dtype': None, 'health': None, 'mesh': None}
    fp = tcc.fingerprint(_mlp(tmx))
    assert fp == jcc.fingerprint(_mlp(mx))

    def entry(rows, meta=meta, fp=fp):
        return {'kind': 'fit_step', 'fp': fp, 'meta': meta,
                'batch': {'data': [[rows, 5], 'float32'],
                          'softmax_label': [[rows], 'float32']}}
    entries = [entry(4), entry(2), entry(6, meta=dict(meta, health='warn')),
               entry(8, fp='0' * 16)]
    keys = {}
    for name, cc in (('jax', jcc), ('torch', tcc)):
        path = tmp_path / name / 'manifest.json'
        os.makedirs(os.path.dirname(str(path)))
        path.write_text(json.dumps({'version': 1, 'traces': entries}))
    with _reference_manifest(str(tmp_path / 'jax' / 'manifest.json')):
        m = _bound_module(mx)
        m._warm_start('acc')
        for f in list(m._fused_aot_pending.values()):
            f.result(timeout=120)
        keys['jax'] = set(m._fused_aot)
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path / 'torch'))
    tcc.ensure_persistent_cache()
    m = _bound_module(tmx)
    m._warm_start('acc')
    keys['torch'] = set(m._warm_sigs)
    assert keys['torch'] == keys['jax'] and len(keys['torch']) == 2
    short = tcc.sig_key({'data': ((2, 5), 'float32'),
                         'softmax_label': ((2,), 'float32')})
    assert short in m._graphs
    assert m._sig_batches[short]['data'].shape == (2, 5)


def test_warm_ups_end_on_the_fit_thread_before_the_first_batch(
        tmp_path, monkeypatch):
    """Each warm-up (the bound signature and a 2-row one only the
    manifest names, each made slow) runs on the thread that calls fit
    and ends before the first batch.  A fit whose batch-end callbacks
    drain the metric (Speedometer) and read and set the parameters ends
    bit for bit where the same fit without a warm start does, with the
    same readings; a set_params after fit stays as it was set."""
    import threading
    import time
    x, y = _data(n=12)
    fp = tcc.fingerprint(_mlp(tmx))
    events = []
    orig = tmx.mod.Module._warm_sig

    def slow_warm(self, sig, shapes):
        events.append(('warm', threading.get_ident()))
        time.sleep(0.2)
        return orig(self, sig, shapes)
    monkeypatch.setattr(tmx.mod.Module, '_warm_sig', slow_warm)

    def run(warm):
        m = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        readings = []

        def touch(param):
            events.append(('batch', threading.get_ident()))
            readings.append(param.eval_metric.get_name_value())
            arg, aux = m.get_params()
            m.set_params(arg, aux)
        m.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
              optimizer='sgd', optimizer_params=OPT, eval_metric='acc',
              arg_params={k: tmx.nd.array(v) for k, v in _params().items()},
              batch_end_callback=[touch,
                                  tmx.callback.Speedometer(4, frequent=1)],
              warm_start=warm)
        return m, readings

    cold, cold_readings = run(False)
    assert [e for e, _ in events] == ['batch'] * 6
    del events[:]
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path))
    tcc.ensure_persistent_cache()
    tcc.record_entry({
        'kind': 'fit_step', 'fp': fp,
        'meta': {'metric': ['mxnet_tpu.metric', 'Accuracy'],
                 'compute_dtype': None, 'health': None, 'mesh': None},
        'batch': {'data': [[2, 5], 'float32'],
                  'softmax_label': [[2], 'float32']}})
    warm, warm_readings = run(True)
    assert [e for e, _ in events] == ['warm'] * 2 + ['batch'] * 6
    assert {t for _, t in events} == {threading.get_ident()}
    assert len(warm._warm_sigs) == 2
    assert warm_readings == cold_readings
    assert all(np.isfinite(v) for r in cold_readings for _, v in r)
    for k, v in cold.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), warm.get_params()[0][k].asnumpy())
    new = {k: tmx.nd.array(v * 2) for k, v in _params().items()}
    warm.set_params(new, {})
    time.sleep(0.3)
    for k, v in warm.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), new[k].asnumpy()), k


_CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import mxnet_tpu_torch as tmx

    class Iter(tmx.io.DataIter):
        """Batches of 4, 4 and 2 rows: two signatures."""
        def __init__(self, x, y):
            super().__init__()
            self.x, self.y, self.i = x, y, 0
            self.batch_size = 4
        @property
        def provide_data(self):
            return [('data', (4, 5))]
        @property
        def provide_label(self):
            return [('softmax_label', (4,))]
        def reset(self):
            self.i = 0
        def next(self):
            if self.i >= len(self.x):
                raise StopIteration
            j = self.i + 4
            self.i = j
            return tmx.io.DataBatch([tmx.nd.array(self.x[j - 4:j])],
                                    [tmx.nd.array(self.y[j - 4:j])], pad=0)

    rng = np.random.RandomState(0)
    x = rng.randn(10, 5).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    rng = np.random.RandomState(1)
    params = {'fc1_weight': rng.randn(8, 5).astype(np.float32) * 0.3,
              'fc1_bias': np.zeros(8, np.float32),
              'fc2_weight': rng.randn(3, 8).astype(np.float32) * 0.3,
              'fc2_bias': np.zeros(3, np.float32)}
    net = tmx.sym.Variable('data')
    net = tmx.sym.FullyConnected(net, num_hidden=8, name='fc1')
    net = tmx.sym.Activation(net, act_type='relu', name='act1')
    net = tmx.sym.FullyConnected(net, num_hidden=3, name='fc2')
    net = tmx.sym.SoftmaxOutput(net, name='softmax')
    m = tmx.mod.Module(net, context=tmx.cpu())
    m.fit(Iter(x, y), num_epoch=2, optimizer='sgd',
          optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
          eval_metric='acc',
          arg_params={k: tmx.nd.array(v) for k, v in params.items()},
          warm_start=sys.argv[1] == 'warm')
    out = {'params': {k: v.asnumpy().tolist()
                      for k, v in m.get_params()[0].items()},
           'warmed': [[list(e) for e in s] for s in
                      getattr(m, '_warm_sigs', [])]}
    print(json.dumps(out))
''')


def test_two_processes_cold_then_warm(tmp_path):
    """A cold child fits over 4-, 4- and 2-row batches; a warm child over
    the same directory warms the 2-row signature the manifest names
    (and the bound one) and ends bit for bit where the cold one did."""
    script = tmp_path / 'child.py'
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=os.getcwd(),
               MXTPU_COMPILE_CACHE=str(tmp_path / 'cache'))
    env.pop('MXTPU_WARM_START', None)
    out = {}
    for mode in ('cold', 'warm'):
        done = subprocess.run([sys.executable, str(script), mode], env=env,
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr
        out[mode] = json.loads(done.stdout.strip().splitlines()[-1])
    for k, v in out['cold']['params'].items():
        assert np.array_equal(np.array(v, np.float32),
                              np.array(out['warm']['params'][k],
                                       np.float32)), k
    short = [['data', [2, 5], 'float32'], ['softmax_label', [2], 'float32']]
    assert out['cold']['warmed'] == []
    assert short in out['warm']['warmed']
    assert len(out['warm']['warmed']) == 2
    doc = json.loads((tmp_path / 'cache' / 'manifest.json').read_text())
    assert len([e for e in doc['traces'] if e['kind'] == 'fit_step']) == 2


# ---------------------------------------------------------------------------
# BucketingModule: the buckets the manifest names
# ---------------------------------------------------------------------------

def _bucket_sym_gen(pkg):
    def sym_gen(key):
        net = pkg.sym.Variable('data')
        net = pkg.sym.mean(net, axis=1, keepdims=True, name='pool')
        net = pkg.sym.FullyConnected(net, num_hidden=6, name='fc1')
        net = pkg.sym.FullyConnected(net, num_hidden=3, name='fc2')
        return (pkg.sym.SoftmaxOutput(net, name='softmax'), ('data',),
                ('softmax_label',))
    return sym_gen


def test_bucketing_warm_start_binds_the_buckets_the_manifest_names(
        tmp_path, monkeypatch):
    """Entries of buckets 8 and 12 (recorded by bucket modules of their
    own fingerprints): a fresh BucketingModule's warm start binds both
    and schedules each bucket's own signature first.  (This sym_gen's
    symbols do not depend on the key, so every bucket's fingerprint is
    one, and each bucket also warms the others' signatures, as the
    reference's fingerprint match would.)"""
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path))
    tcc.ensure_persistent_cache()
    gen = _bucket_sym_gen(tmx)
    for key in (8, 12):
        tcc.record_entry({
            'kind': 'fit_step', 'fp': tcc.fingerprint(gen(key)[0]),
            'meta': {'metric': ['mxnet_tpu.metric', 'Accuracy'],
                     'compute_dtype': None, 'health': None, 'mesh': None},
            'batch': {'data': [[4, key], 'float32'],
                      'softmax_label': [[4], 'float32']}})
    mod = tmx.mod.BucketingModule(gen, default_bucket_key=16,
                                  context=tmx.cpu())
    mod.bind(data_shapes=[('data', (4, 16))],
             label_shapes=[('softmax_label', (4,))])
    mod.init_params()
    mod.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    mod._warm_start('acc')
    assert sorted(mod._buckets) == [8, 12, 16]
    assert mod._curr_bucket_key == 16
    for key, m in mod._buckets.items():
        assert dict((n, s) for n, s, _ in m._warm_sigs[0])['data'] == \
            (4, key)


# ---------------------------------------------------------------------------
# The cubin store
# ---------------------------------------------------------------------------

class _Shim(object):
    def __init__(self, version=(12, 8)):
        self.version = version

    def nvrtc_version(self):
        return self.version


def test_cubin_store_key_atomic_write_and_a_cut_file(tmp_path, monkeypatch):
    """A miss compiles and stores; the next process-local call loads it
    (no compile, a hit saving the stored seconds); a file cut short is a
    miss, counted, compiled again and written whole."""
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path))
    monkeypatch.setattr(torch.cuda, 'get_device_capability',
                        lambda index=None: (9, 0))
    compiled = []

    def fake_compile(shim, source, name):
        compiled.append(name)
        return b'\x7fELF' + hashlib.sha1(source.encode()).digest() * 8

    monkeypatch.setattr(trtc, '_compile', fake_compile)
    src = 'extern "C" __global__ void k(float* y) { y[0] = 1; }'
    shim = _Shim()
    key = tcc.cubin_key(src, 'k', (9, 0), (12, 8))
    parts = b''.join(p.encode() + b'\0' for p in (src, 'k', '9.0', '12.8'))
    assert key == hashlib.sha256(parts).hexdigest()
    assert len({key, tcc.cubin_key(src, 'k', (8, 0), (12, 8)),
                tcc.cubin_key(src, 'k', (9, 0), (12, 9)),
                tcc.cubin_key(src + ' ', 'k', (9, 0), (12, 8)),
                tcc.cubin_key(src, 'j', (9, 0), (12, 8))}) == 5
    first = trtc._cubin(shim, src, 'k', 0)
    path = tmp_path / 'rtc' / (key + '.cubin')
    assert compiled == ['k'] and path.exists()
    assert os.listdir(str(tmp_path / 'rtc')) == [key + '.cubin']
    assert tins.counter_value('compile.cache_misses') == 1
    assert trtc._cubin(shim, src, 'k', 0) == first
    assert compiled == ['k']
    assert tins.counter_value('compile.cache_hits') == 1
    assert tins.metrics_snapshot()['timers'][
        'compile.time_saved_secs']['count'] == 1
    whole = path.read_bytes()
    path.write_bytes(whole[:len(whole) // 2])
    assert trtc._cubin(shim, src, 'k', 0) == first
    assert compiled == ['k', 'k']
    assert tins.counter_value('compile.cache_misses') == 2
    rewritten = path.read_bytes()       # whole again (its seconds new)
    assert len(rewritten) == len(whole) and rewritten[24:] == whole[24:]
    path.write_bytes(b'garbage')
    assert trtc._cubin(shim, src, 'k', 0) == first
    assert tins.counter_value('compile.cache_misses') == 3
    assert trtc._cubin(_Shim((12, 9)), src, 'k', 0) == first
    assert len(compiled) == 4               # another NVRTC: another key


def test_no_cubin_store_without_the_knob(tmp_path, monkeypatch):
    monkeypatch.setattr(trtc, '_compile', lambda shim, s, n: b'cubin')
    assert trtc._cubin(_Shim(), 'src', 'k', 0) == b'cubin'
    assert tcc.cache_dir() is None
    assert tins.counter_value('compile.cache_misses') == 0


# ---------------------------------------------------------------------------
# perfwatch: a signature's FLOPs filed and read back
# ---------------------------------------------------------------------------

def test_step_cost_rows_feed_a_warm_process(tmp_path, monkeypatch):
    """With perfwatch on, the cold fit counts the step's FLOPs and files
    a step_cost row; a second module over the same manifest takes them
    from the row (no counting pass) and reports the same FLOPs."""
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path))
    monkeypatch.setenv('MXTPU_PERFWATCH', '1')
    t_perfwatch.refresh()
    x, y = _data()
    m = _fit(tmx, x, y)
    (row,) = t_perfwatch.executables()
    (cost,) = tcc.manifest_entries('step_cost')
    assert cost['flops'] == row['flops'] > 0
    assert cost['program'] == 'fit_step' and cost['num_devices'] == 1
    key = m._perf_key(list(m._graphs)[0])
    assert t_perfwatch.manifest_flops('fit_step', key) == row['flops']
    t_perfwatch.clear_executables()
    counted = []
    real = t_perfwatch.count_flops

    def spy():
        counted.append(1)
        return real()
    monkeypatch.setattr(t_perfwatch, 'count_flops', spy)
    _fit(tmx, x, y)
    (again,) = t_perfwatch.executables()
    assert counted == [] and again['flops'] == row['flops']
