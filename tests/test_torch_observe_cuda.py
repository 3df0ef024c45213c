"""The observability planes on the card's captured fit step: the health
probe inside the CUDA graph (skip_update restores the step bit for bit,
the probe only reads, abort raises at the drain), and the performance
plane's FLOPs counted over the eager warm-up before the capture (each
kernel wrapper's own report among them), its phases timed by CUDA events
and its graph-pool ledger entry.

Every test needs a CUDA device (CUDA graphs have no CPU mode) and skips
without one; the CPU parity of the same code against the JAX package is
in tests/test_torch_health.py and tests/test_torch_perfwatch.py.  The
file imports no jax, so the card's host runs it (``python -m pytest
tests/test_torch_observe_cuda.py -m cuda --noconftest``;
``chip_smoke.py``'s capture phase does)."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import (compile_cache, convert, health, instrument,
                             perfwatch)
from mxnet_tpu_torch.models import resnet as tresnet

ROWS, STEPS = 8, 4
OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    for knob in ('MXTPU_ASYNC_DEPTH', 'MXTPU_DEVICE_FEED', 'MXTPU_FUSED_FIT',
                 'MXTPU_WARM_START', 'MXTPU_HEALTH_SENTINELS',
                 'MXTPU_HEALTH_ACTION', 'MXTPU_PERFWATCH', 'MXTPU_IOWATCH'):
        monkeypatch.delenv(knob, raising=False)
    yield
    health.deactivate()
    perfwatch.set_enabled(False)
    perfwatch.clear_executables()
    perfwatch.ledger_reset()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = False


def _case(bad=None):
    sym = tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                         filter_list=[8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 64, 64))
    arg, aux = convert.random_params(sym, {'data': (ROWS, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((ROWS * STEPS, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, ROWS * STEPS).astype(np.float32)
    if bad is not None:
        x[bad * ROWS + 3, 1, 10, 20] = np.nan
    return sym, arg, aux, x, y


def _fit(sym, arg, aux, x, y, callbacks=(), epoch_end=None):
    mod = tmx.Module(sym, context=tmx.gpu(0), compute_dtype=torch.bfloat16)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=ROWS), num_epoch=1,
            optimizer='sgd', optimizer_params=OPT, eval_metric='ce',
            arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
            batch_end_callback=list(callbacks),
            epoch_end_callback=epoch_end)
    torch.cuda.synchronize()
    return mod


def _state(mod):
    torch.cuda.synchronize()
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()},
            {'%s.%d' % (k, i): t.detach().cpu().numpy()
             for k, v in mod._fused_opt_state.items()
             for i, t in enumerate(compile_cache.step_tensors(v))})


@pytest.mark.cuda
def test_captured_skip_update_restores_the_step_bit_for_bit(dev,
                                                            monkeypatch):
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'skip_update')
    bad = 2
    sym, arg, aux, x, y = _case(bad)
    states, values = [], []
    mod = _fit(sym, arg, aux, x, y,
               callbacks=[lambda p: states.append(_state(p.locals['self']))],
               epoch_end=lambda *a: values.append(health.last_values()))
    caps = list(mod._graphs.values())
    assert len(caps) == 1 and caps[0].captured and \
        caps[0].replays == STEPS - 1
    for before, after in zip(states[bad - 1], states[bad]):
        for k, v in before.items():
            np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert values[0]['nan_steps'] == 1
    assert values[0]['first_bad_step'] == values[0]['last_bad_step'] == bad
    for part in states[-1]:
        assert all(np.isfinite(v).all() for v in part.values())


@pytest.mark.cuda
def test_captured_probe_only_reads(dev, monkeypatch):
    """Sentinels off and under warn: the same parameters bit for bit, the
    same launches per step, no health-forced sync."""
    from mxnet_tpu_torch.ops import fused, fused_conv
    sym, arg, aux, x, y = _case()
    got = []
    for on in ('0', '1'):
        monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', on)
        kernels = (fused.fused_scale_bias_dot,
                   fused_conv.fused_scale_bias_conv3x3, fused.fused_bn_relu)
        before = [k.launches for k in kernels]
        syncs = instrument.counter_value('metric.host_syncs')
        mod = _fit(sym, arg, aux, x, y)
        got.append((_state(mod)[0], [k.launches - b for k, b in
                                     zip(kernels, before)],
                    instrument.counter_value('metric.host_syncs') - syncs))
    assert got[0][1] == got[1][1] and got[0][2] == got[1][2]
    assert instrument.counter_value('health.host_syncs') == 0
    for k, v in got[0][0].items():
        np.testing.assert_array_equal(got[1][0][k], v, err_msg=k)


@pytest.mark.cuda
def test_captured_abort_raises_at_the_drain(dev, monkeypatch):
    monkeypatch.setenv('MXTPU_HEALTH_SENTINELS', '1')
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'abort')
    sym, arg, aux, x, y = _case(1)
    with pytest.raises(health.TrainingDivergedError) as exc:
        _fit(sym, arg, aux, x, y,
             callbacks=[tmx.callback.Speedometer(ROWS, 1)])
    assert (exc.value.first_bad_step, exc.value.last_bad_step,
            exc.value.nan_steps) == (1, 1, 1)


@pytest.mark.cuda
def test_perfwatch_on_the_captured_step(dev, monkeypatch):
    """The FLOPs of the step, counted over its warm-up (the kernels'
    analytic counts included), equal the symbol's analytic count; each
    step is timed by two CUDA events (the first as ``capture``, the
    replays as ``dispatch``), read at the drain; the graph pool is one
    ledger entry."""
    monkeypatch.setenv('MXTPU_PERFWATCH', '1')
    sym, arg, aux, x, y = _case()
    instrument.reset_metrics()
    events0 = perfwatch.events_recorded
    _fit(sym, arg, aux, x, y)
    rows = perfwatch.executables()
    assert len(rows) == 1 and rows[0]['kernel_flops'] > 0
    assert rows[0]['flops'] == perfwatch.analytic_step_flops(
        sym, {'data': (ROWS, 3, 64, 64), 'softmax_label': (ROWS,)})
    assert perfwatch.events_recorded - events0 == 2 * STEPS
    hists = instrument.metrics_snapshot()['histograms']
    assert hists['perf.phase.capture']['count'] == 1
    assert hists['perf.phase.dispatch']['count'] == STEPS - 1
    assert perfwatch.ledger_top(1)[0][0] == 'graph_pool'
    assert rows[0]['pool_bytes'] > 0


def _kernel_cases(d):
    """(kernel, wrapper call, analytic helper's count) for each kernel
    that reports FLOPs, at a bf16 shape its path gives it, plus #2, which
    reports none."""
    from mxnet_tpu_torch.ops import attention, fused, fused_conv
    g = torch.Generator(device=d).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=d).to(torch.bfloat16)

    x, w = rnd(256, 512), rnd(512, 128)
    s, b = torch.ones(512, device=d), torch.zeros(512, device=d)
    xc, wc = rnd(2, 14, 14, 64), rnd(3, 3, 64, 64)
    sc, bc = torch.ones(64, device=d), torch.zeros(64, device=d)
    q, k = rnd(8, 128, 64), rnd(8, 192, 64)
    return {
        'fused_scale_bias_dot': (
            fused.fused_scale_bias_dot,
            lambda: fused.fused_scale_bias_dot(x, w, s, b, True),
            fused.fused_scale_bias_dot_flops(x, w)),
        'fused_dot_epilogue': (
            fused.fused_dot_epilogue,
            lambda: fused.fused_dot_epilogue(x, w, torch.zeros(128, device=d),
                                             True),
            fused.fused_dot_epilogue_flops(x, w)),
        'fused_scale_bias_conv3x3': (
            fused_conv.fused_scale_bias_conv3x3,
            lambda: fused_conv.fused_scale_bias_conv3x3(xc, wc, sc, bc, 2),
            fused_conv.fused_scale_bias_conv3x3_flops(xc, wc, 2)),
        'flash_attention': (
            attention.flash_attention,
            lambda: attention.flash_attention(q, k, k, causal=True),
            attention.flash_attention_flops(q, k)),
        'fused_bn_relu': (
            fused.fused_bn_relu,
            lambda: fused.fused_bn_relu(xc.permute(0, 3, 1, 2).contiguous(),
                                        sc, bc),
            0),
    }


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['fused_scale_bias_dot', 'fused_dot_epilogue',
                                  'fused_scale_bias_conv3x3',
                                  'flash_attention', 'fused_bn_relu'])
def test_each_wrapper_reports_its_analytic_flops(dev, name):
    """Where a wrapper launches its kernel inside count_flops, the count
    it reports is its analytic helper's, the count FlopCounterMode gives
    its plain version (tests/test_torch_perfwatch.py)."""
    kernel, call, want = _kernel_cases(dev)[name]
    call()                          # the build, outside the count
    before = kernel.launches
    with perfwatch.count_flops() as fc:
        call()
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    assert fc.kernel_flops == want
