"""The performance-attribution plane of the PyTorch port
(``perfwatch.py``) against the JAX package on the CPU.

- ``mfu`` and ``roofline_mandatory`` are equal on equal inputs; the peak
  table holds the H100 and the nominal CPU entry, no TPU figure.
- Each hand-written kernel's analytic FLOP count, the one its wrapper
  reports where it launches, equals FlopCounterMode's count of its plain
  version.
- A ``Module.fit`` step's count (FlopCounterMode over the step before
  capture) equals the symbol's analytic count of its convolutions and
  dots exactly, and stands at a bounded ratio to the JAX package's
  ``xla.flops`` for the same step, which counts every op: 0.824 for the
  narrow ResNet v2 here (39,745,536 against 48,214,836); the bound is
  [0.7, 1.0].
- The ledger, the sampled-step sync budget, OOM forensics, and the off
  path by counting: no FLOP count, no CUDA event, no health buffer."""
import gc
import json
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import attention, fused, fused_conv

from test_torch_health import reset_planes


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ('MXTPU_PERFWATCH', 'MXTPU_STEP_SAMPLE', 'MXTPU_PEAK_FLOPS',
              'MXTPU_HEALTH_SENTINELS', 'MXTPU_FLIGHT_RECORDER'):
        monkeypatch.delenv(k, raising=False)
    met = [(p.instrument, p.instrument.metrics_enabled()) for p in (mx, tmx)]
    reset_planes()
    for ins, _ in met:
        ins.reset_metrics()
        ins.set_metrics(True)
    yield
    reset_planes()
    t_perfwatch.refresh()
    for ins, m in met:
        ins.set_metrics(m)
        ins.reset_metrics()


def test_mfu_and_roofline_match_jax(monkeypatch):
    for args in ((1e12, 2.0, 989e12), (0.0, 2.0, 989e12), (3e12, 0.0, 1e14),
                 (4.5e13, 17.5, 2e11)):
        assert t_perfwatch.mfu(*args) == j_perfwatch.mfu(*args)
    for args in ((1e9, 2.0, 3.35e12), (0.0, 1.0, 1e11), (7e8, 3.5, 1e11)):
        assert t_perfwatch.roofline_mandatory(*args) == \
            j_perfwatch.roofline_mandatory(*args)
    # the table: the H100 and the reference's nominal CPU entry only
    assert set(t_perfwatch.PEAKS) == {'NVIDIA H100 80GB HBM3', 'cpu'}
    assert not any('TPU' in k for k in t_perfwatch.PEAKS)
    assert t_perfwatch.PEAKS['NVIDIA H100 80GB HBM3'] == (989e12, 3.35e12)
    assert t_perfwatch.PEAKS['cpu'] == j_perfwatch.PEAKS['cpu']
    assert t_perfwatch.DEFAULT_PEAK_KEY == 'NVIDIA H100 80GB HBM3'
    assert t_perfwatch.device_peaks('another card') == \
        t_perfwatch.PEAKS['NVIDIA H100 80GB HBM3']
    assert t_perfwatch.peaks() == t_perfwatch.PEAKS['cpu']
    monkeypatch.setenv('MXTPU_PEAK_FLOPS', '5e12')
    assert t_perfwatch.peaks()[0] == 5e12
    assert t_perfwatch.mfu(1e12, 1.0) == pytest.approx(0.2)


def _plain_count(fn, *args):
    with t_perfwatch.count_flops() as fc:
        fn(*args)
    return fc.flops


@pytest.mark.parametrize('m,k,n', [(32, 64, 16), (7, 5, 3), (256, 128, 96)])
def test_gemm_kernel_flops_equal_plain_count(m, k, n):
    r = np.random.RandomState(m)
    x = torch.from_numpy(r.randn(m, k).astype(np.float32))
    w = torch.from_numpy(r.randn(k, n).astype(np.float32))
    s, b = torch.ones(k), torch.zeros(k)
    assert fused.fused_scale_bias_dot_flops(x, w) == _plain_count(
        fused.fused_scale_bias_dot_plain, x, w, s, b, True)
    assert fused.fused_dot_epilogue_flops(x, w) == _plain_count(
        fused.fused_dot_epilogue_plain, x, w, torch.zeros(n), True)
    # #2 reports nothing: its plain version is elementwise
    assert _plain_count(fused.fused_bn_relu_plain, x, torch.ones(k),
                        torch.zeros(k)) == 0


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('shape', [(2, 7, 9, 4, 6), (1, 14, 14, 16, 8)])
def test_conv_kernel_flops_equal_plain_count(shape, stride):
    n, h, w_, c, f = shape
    x = torch.randn(n, h, w_, c)
    w = torch.randn(3, 3, c, f)
    assert fused_conv.fused_scale_bias_conv3x3_flops(x, w, stride) == \
        _plain_count(fused_conv.fused_scale_bias_conv3x3_plain, x, w,
                     torch.ones(c), torch.zeros(c), stride)


@pytest.mark.parametrize('causal', [False, True])
def test_attention_kernel_flops_equal_plain_count(causal):
    q, k = torch.randn(6, 33, 16), torch.randn(6, 40, 16)
    assert attention.flash_attention_flops(q, k) == _plain_count(
        attention.flash_attention_plain, q, k, k, 0.25, causal)


def test_kernel_flops_counted_only_where_a_kernel_launches():
    """The wrappers report inside count_flops only; outside it the
    report is a no-op."""
    assert t_perfwatch._kernel_sink is None
    t_perfwatch.note_kernel_flops(123)
    with t_perfwatch.count_flops() as fc:
        t_perfwatch.note_kernel_flops(100)
        with t_perfwatch.count_flops() as inner:
            t_perfwatch.note_kernel_flops(7)
    assert (fc.kernel_flops, inner.kernel_flops) == (100, 7)
    assert t_perfwatch._kernel_sink is None


def _narrow_resnet(res):
    return res.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[8, 16, 32, 64, 128], num_classes=10,
                      image_shape=(3, 64, 64))


def test_step_flops_equal_symbol_count_and_bound_xla(monkeypatch):
    """Module.fit of the narrow ResNet v2 with MXTPU_PERFWATCH=1 in both
    packages: the port's registered step FLOPs equal the symbol's
    analytic count exactly; against the JAX package's xla.flops the
    ratio is 0.824, inside [0.7, 1.0]."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('MXTPU_PERFWATCH', '1')
    batch = 4
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2 * batch, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, 2 * batch).astype(np.float32)
    for pkg in (tmx, mx):
        m = pkg.mod.Module(pkg.sym.load_json(tsym.tojson()),
                           context=pkg.cpu())
        m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
              optimizer_params={'learning_rate': 0.05, 'momentum': 0.9},
              arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
              aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    rows = [r for r in t_perfwatch.executables() if r['kind'] == 'fit_step']
    jrows = [r for r in j_perfwatch.executables()
             if r['kind'] == 'fit_step']
    assert len(rows) == 1 and len(jrows) == 1
    analytic = t_perfwatch.analytic_step_flops(
        tsym, {'data': (batch, 3, 64, 64), 'softmax_label': (batch,)})
    assert rows[0]['flops'] == analytic == 39745536
    ratio = rows[0]['flops'] / jrows[0]['flops']
    assert 0.7 <= ratio <= 1.0, ratio
    g = tmx.instrument.metrics_snapshot()['gauges']
    assert g['xla.fit_step[%s].flops' % rows[0]['key']] == analytic
    assert g['perf.step_flops'] == analytic and g['perf.mfu'] > 0
    hists = tmx.instrument.metrics_snapshot()['histograms']
    assert hists['perf.phase.capture']['count'] == 1
    assert hists['perf.phase.dispatch']['count'] == 1


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=16,
                                 name='pfc1')
    net = pkg.sym.Activation(net, act_type='relu', name='pact1')
    net = pkg.sym.FullyConnected(net, num_hidden=4, name='pfc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _fit(monkeypatch, env, nbatch=8, bs=8):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(3)
    X = rng.randn(nbatch * bs, 10).astype(np.float32)
    Y = (X @ rng.randn(10, 4)).argmax(1).astype(np.float32)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=bs), num_epoch=1,
            optimizer_params={'learning_rate': 0.1},
            initializer=tmx.init.Uniform(0.05),
            batch_end_callback=[tmx.callback.Speedometer(bs, 3)])
    return mod


def test_sampled_step_sync_budget(monkeypatch):
    """MXTPU_STEP_SAMPLE=N costs exactly ceil(steps/N) perf syncs and
    leaves metric.host_syncs unchanged."""
    _fit(monkeypatch, {'MXTPU_PERFWATCH': '1'})
    base = tmx.instrument.metrics_snapshot()['counters']
    assert base.get('perf.host_syncs', 0) == 0
    tmx.instrument.reset_metrics()
    _fit(monkeypatch, {'MXTPU_PERFWATCH': '1', 'MXTPU_STEP_SAMPLE': '3'})
    snap = tmx.instrument.metrics_snapshot()
    assert snap['counters'].get('metric.host_syncs') == \
        base.get('metric.host_syncs')
    assert snap['counters']['perf.host_syncs'] == math.ceil(8 / 3)
    assert snap['histograms']['perf.step_latency']['count'] == \
        math.ceil(8 / 3)


def test_ledger_alloc_free_and_donate_guard():
    t_perfwatch.set_enabled(True)
    a = torch.ones(256, 4)          # 4096 bytes
    b = torch.ones(128, 2)          # 1024 bytes
    t_perfwatch.ledger_alloc('site.a', a)
    nd_b = t_perfwatch.ledger_alloc('site.b', tmx.nd.array(b.numpy()))
    holder = type('Pool', (), {})()
    t_perfwatch.ledger_alloc('graph_pool', holder, nbytes=10000)
    stats = t_perfwatch.ledger_stats()
    assert stats['live_bytes'] == 4096 + 1024 + 10000
    assert t_perfwatch.ledger_top(1) == [('graph_pool', 10000, 1)]
    del nd_b
    gc.collect()                    # a free retires its bytes
    assert t_perfwatch.ledger_stats()['live_bytes'] == 4096 + 10000
    t_perfwatch.ledger_donate(a)
    del a, holder
    gc.collect()
    stats = t_perfwatch.ledger_stats()
    assert stats['live_bytes'] == 0 and stats['peak_bytes'] == 15120
    c = tmx.instrument.metrics_snapshot()['counters']
    assert c['mem.donations'] == 1 and c['mem.frees'] == 2
    assert stats['device'] == {}    # no CUDA in this process
    t_perfwatch.ledger_donate(object())


def test_off_path_counts_nothing(monkeypatch):
    """Planes off: no FLOP count, no CUDA event, no health buffer, no
    perf.* or mem.* metric, and the phase hook is the shared no-op."""
    events0 = t_perfwatch.events_recorded
    buffers0 = dict(t_health._buffers)
    _fit(monkeypatch, {})
    assert t_perfwatch.phase('dispatch', 'cpu') is tmx.instrument.NULL_CTX
    assert t_perfwatch.events_recorded == events0
    assert t_health._buffers == buffers0
    assert t_perfwatch.executables() == []
    snap = tmx.instrument.metrics_snapshot()
    assert not any(k.startswith(('perf.', 'mem.', 'xla.', 'health.'))
                   for section in ('counters', 'gauges', 'histograms')
                   for k in snap.get(section, {}))


def test_oom_forensics(tmp_path):
    """An out-of-memory error at the dispatch site becomes a durable
    'oom' flight record naming the signature and the top ledger
    entries; any other error passes through."""
    assert t_perfwatch.is_oom(torch.cuda.OutOfMemoryError('x'))
    assert t_perfwatch.is_oom(RuntimeError('CUDA error: out of memory'))
    assert t_perfwatch.on_error(ValueError('shape')) is None
    t_perfwatch.set_enabled(True)
    keep = torch.ones(64)
    t_perfwatch.ledger_alloc('fit.outputs', keep)
    t_perfwatch.register_executable('fit_step', ('fp', 'sig'),
                                    {'flops': 12.0})
    t_health.install_flight_recorder(str(tmp_path))
    try:
        path = t_perfwatch.on_error(torch.cuda.OutOfMemoryError('boom'),
                                    'fit_step', ('fp', 'sig'))
    finally:
        t_health._recorder = None
    assert path
    with open(os.path.join(str(tmp_path), 'flightrec-rank0-oom.json')) as f:
        doc = json.load(f)['oom']
    assert doc['executable']['flops'] == 12.0
    assert doc['ledger']['top'][0]['site'] == 'fit.outputs'
    assert 'boom' in doc['error']
