"""Whole-step capture of the PyTorch port (``compile_cache.CapturedStep``),
against the JAX package on the CPU and, marked ``cuda``, captured against
eager (``NaiveEngine``) on the card.

CPU: the batch-signature helpers equal the JAX package's; the capturable
fit step body, which on the CPU runs eagerly on its fixed buffers (batch
copied into the bound arrays, lr in a 0-dim tensor filled each step, the
metric folded in place), trains a narrow ResNet v2 and a narrow LM like
JAX ``Module.fit`` with an lr schedule that changes the lr at step 2;
the warm-start snapshot undoes its warm-up step bit for bit; and the
sync-free loop (``MXTPU_ASYNC_DEPTH=2``, the device feed) trains exactly
as the synchronous one.  Tolerances, those of ``tests/test_torch_train.py``
and ``tests/test_torch_lm.py``: parameters and momentum after a fit rtol
1e-4, atol 1e-5; the metric rtol 1e-5.

Card (they skip without one; on the GPU host ``python -m pytest
tests/test_torch_capture.py -q -m cuda --noconftest``): each captured
path against the same steps under ``NaiveEngine`` from the same numpy
state, within chip_smoke.py's train-parity bound (rtol 1e-3, atol
1e-5; captured and eager run the same kernels, so most come out
bit-identical); launch counters advance per replay; random nodes draw
anew on each replay; a host sync in a step raises naming the node; a
rebinding drops the graphs; a Custom graph is captured in segments
(``compile_cache.StagedStep``), bit for bit the eager step.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache, convert, engine
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import operator as top
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops import registry

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
LM_CFG = dict(vocab_size=200, num_embed=64, num_heads=4, num_layers=2,
              seq_len=32)


def _jax(name):
    """A module of the JAX package, imported in the CPU tests only: the
    card's host runs the cuda tests without jax."""
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _aggressive(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    for knob in ('MXTPU_ASYNC_DEPTH', 'MXTPU_DEVICE_FEED',
                 'MXTPU_WARM_START', 'MXTPU_PRECOMPILE_BUCKETS'):
        monkeypatch.delenv(knob, raising=False)
    yield
    engine.set_engine_type('ThreadedEnginePerDevice')


def _narrow_resnet(res):
    return res.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[8, 16, 32, 64, 128], num_classes=10,
                      image_shape=(3, 64, 64))


def _resnet_case(batch, steps):
    sym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(sym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    return sym, arg, aux, x, y


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('batch', [
    {'data': ((32, 3, 224, 224), 'float32'),
     'softmax_label': ((32,), 'float32')},
    {'data': ((16, 512), 'int32'), 'softmax_label': ((16, 512), 'float32'),
     'mask': ((16, 1, 512), 'bfloat16')}], ids=['resnet', 'lm'])
def test_batch_sig_equals_jax(batch):
    """The port's key of a placed batch (torch tensors) is the JAX
    package's key of the same batch (numpy / jax arrays)."""
    jnp, jcc = _jax('jax.numpy'), _jax('mxnet_tpu.compile_cache')
    tb = {k: torch.zeros(s, dtype=getattr(torch, dt))
          for k, (s, dt) in batch.items()}
    jb = {k: jnp.zeros(s, dtype=getattr(jnp, dt))
          for k, (s, dt) in batch.items()}
    assert compile_cache.batch_sig(tb) == jcc.batch_sig(jb)
    assert compile_cache.sig_key(batch) == jcc.sig_key(batch)
    assert compile_cache.sig_key(batch, mesh='4x2') == \
        jcc.sig_key(batch, mesh='4x2')


@pytest.mark.parametrize('n,minimum', [(1, 1), (3, 1), (8, 1), (9, 1),
                                       (3, 8), (0, 1), (33, 4)])
def test_pad_to_bucket_equals_jax(n, minimum):
    jcc = _jax('mxnet_tpu.compile_cache')
    assert compile_cache.pad_to_bucket(n, minimum) == \
        jcc.pad_to_bucket(n, minimum=minimum)


def test_fingerprint_equals_jax():
    mx, jcc = _jax('mxnet_tpu'), _jax('mxnet_tpu.compile_cache')
    sym = _narrow_resnet(tresnet)
    assert compile_cache.fingerprint(sym) == \
        jcc.fingerprint(mx.sym.load_json(sym.tojson()))


# ---------------------------------------------------------------------------
# the rule that keeps a step eager
# ---------------------------------------------------------------------------

@top.register('sqr_capture')
class _SqrProp(top.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=True)

    def list_arguments(self):
        return ['data']

    def list_outputs(self):
        return ['output']

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _Sqr()


class _Sqr(top.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], tmx.nd.square(in_data[0]))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0] * in_data[0] * 2.0)


def _custom_symbol():
    fc = tmx.sym.FullyConnected(tmx.sym.Variable('data'), num_hidden=8,
                                name='fc')
    sq = tmx.sym.Custom(fc, op_type='sqr_capture', name='sq')
    return tmx.sym.SoftmaxOutput(sq, name='softmax')


def test_capture_skip_rule(monkeypatch):
    """Eager by rule, before any capture: the CPU, NaiveEngine, a Custom
    node under the mirror; a plain graph on a card device would be
    captured, and so would a Custom graph (in segments)."""
    plain = _narrow_resnet(tresnet)
    cuda = torch.device('cuda', 0)
    assert compile_cache.capture_skip_reason('cpu', plain) == 'cpu'
    assert compile_cache.capture_skip_reason(cuda, plain) is None
    assert compile_cache.capture_skip_reason(cuda, _custom_symbol()) is None
    monkeypatch.setenv('MXNET_BACKWARD_DO_MIRROR', '1')
    assert compile_cache.capture_skip_reason(cuda, _custom_symbol()) == \
        'Custom under the mirror'
    assert compile_cache.capture_skip_reason(
        cuda, _custom_symbol(), is_train=False) is None
    monkeypatch.delenv('MXNET_BACKWARD_DO_MIRROR')
    drop = tmx.sym.Dropout(tmx.sym.Variable('data'), p=0.5, name='drop')
    assert compile_cache.random_nodes(drop) == ['drop']
    assert compile_cache.random_nodes(drop, is_train=False) == []
    engine.set_engine_type('NaiveEngine')
    assert compile_cache.capture_skip_reason(cuda, plain) == 'NaiveEngine'


def test_skipped_steps_are_counted():
    """Each step that stays eager by rule counts compile.capture_skipped
    once: a CPU Module's step (once per signature, not per batch) and
    make_train_step(donate=False)."""
    from mxnet_tpu_torch.parallel import train_step as tts
    sym, arg, aux, x, y = _resnet_case(2, 3)
    before = tmx.instrument.counter_value('compile.capture_skipped')
    mod = tmx.Module(sym, context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=2), num_epoch=1,
            optimizer='sgd', optimizer_params=OPT,
            arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    assert tmx.instrument.counter_value('compile.capture_skipped') == \
        before + 1
    (cap,) = mod._graphs.values()
    assert cap.skip == 'cpu' and not cap.captured
    tts.make_train_step(sym, tts.make_sgd_momentum(), ('data',),
                        donate=False)
    assert tmx.instrument.counter_value('compile.capture_skipped') == \
        before + 2


# ---------------------------------------------------------------------------
# the capturable body on the CPU against JAX Module.fit
# ---------------------------------------------------------------------------

def _sched(pkg):
    # lr 0.05 for step 1, halved from step 2 on
    return pkg.lr_scheduler.FactorScheduler(1, 0.5)


def _fit_with_schedule(pkg, sym, arg, aux, x, y, batch, metric):
    m = pkg.mod.Module(sym, context=pkg.cpu())
    m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
          eval_metric=metric, optimizer='sgd',
          optimizer_params=dict(OPT, lr_scheduler=_sched(pkg)),
          arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
          aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    return m


def _momentum(state):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in state.items() if v is not None}


@pytest.mark.parametrize('model', ['resnet', 'lm'])
def test_capturable_body_matches_jax_fit(model):
    """Four steps of Module.fit through the capturable body (run eagerly
    on its fixed buffers on the CPU) with the lr halved from step 2 on
    and a device metric, against JAX Module.fit: parameters, aux,
    momentum and the metric."""
    mx, jmodels = _jax('mxnet_tpu'), _jax('mxnet_tpu.models')
    steps = 4
    if model == 'resnet':
        batch = 4
        tsym, arg, aux, x, y = _resnet_case(batch, steps)
        jsym = mx.sym.load_json(tsym.tojson())
        name = 'acc'
    else:
        batch, t = 4, LM_CFG['seq_len']
        tsym = tmodels.get_symbol('transformer_lm', **LM_CFG)
        jsym = jmodels.get_symbol('transformer_lm', **LM_CFG)
        arg, aux = convert.random_params(
            tsym, {'data': (batch, t), 'softmax_label': (batch, t)}, 0,
            init='normal')
        v = LM_CFG['vocab_size']
        x = np.random.RandomState(2).randint(0, v, (steps * batch, t)) \
            .astype(np.float32)
        y = (x + 1) % v
        name = 'ce'
    tmetric, jmetric = tmx.metric.create(name), mx.metric.create(name)
    tm = _fit_with_schedule(tmx, tsym, arg, aux, x, y, batch, tmetric)
    jm = _fit_with_schedule(mx, jsym, arg, aux, x, y, batch, jmetric)
    assert tm._optimizer.host_lr() == jm._optimizer.host_lr() < \
        OPT['learning_rate']
    (ta, tx), (ja, jx) = tm.get_params(), jm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for got, want in ((ta, ja), (tx, jx)):
        for k in want:
            np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    tmom, jmom = _momentum(tm._fused_opt_state), _momentum(
        jm._fused_opt_state)
    assert sorted(tmom) == sorted(jmom)
    for k in jmom:
        np.testing.assert_allclose(tmom[k], jmom[k], rtol=1e-4, atol=1e-5,
                                   err_msg='momentum of %s' % k)
    (tn, tv), (jn, jv) = tmetric.get(), jmetric.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-5)


def _module(sym, arg, aux, batch, ctx, dtype=None):
    m = tmx.Module(sym, context=ctx, compute_dtype=dtype)
    m.bind(data_shapes=[('data', (batch, 3, 64, 64))],
           label_shapes=[('softmax_label', (batch,))])
    m.init_params(arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                  aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    m.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    return m


def test_warm_step_is_undone_bit_for_bit():
    """The warm start's warm-up runs the step and writes back
    parameters, aux, optimizer state and the metric's accumulator; the
    update counts never move."""
    sym, arg, aux, x, y = _resnet_case(2, 1)
    mod = _module(sym, arg, aux, 2, tmx.cpu())
    metric = tmx.metric.create('acc')
    mod._warm_start(metric)
    batch = tmx.io.DataBatch([tmx.nd.array(x)], [tmx.nd.array(y)])
    mod._exec_group.load_batch(batch)
    cap = mod._step_graph(*mod._fused_buffers())
    ran = []
    body = cap.body
    cap.body = lambda: ran.append(1) or body()
    mod._fit_step(batch, metric)          # momentum and metric non-zero
    params, _, aux_, _ = mod._fused_buffers()
    state = {k: v.clone() for k, v in
             list(params.items()) + list(aux_.items())}
    mom = {k: v.clone() for k, v in mod._fused_opt_state.items()}
    acc = metric._dev_sum.clone()
    counts = dict(mod._optimizer._index_update_count)
    mod._warm_step(cap)
    assert len(ran) == 2
    params, _, aux_, _ = mod._fused_buffers()
    for k, v in list(params.items()) + list(aux_.items()):
        assert torch.equal(v, state[k]), k
    for k, v in mod._fused_opt_state.items():
        assert torch.equal(v, mom[k]), k
    assert torch.equal(metric._dev_sum, acc)
    assert mod._optimizer._index_update_count == counts


def _fit_params(sym, arg, aux, x, y, batch, metric):
    m = tmx.Module(sym, context=tmx.cpu())
    m.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=2,
          eval_metric=metric, optimizer='sgd', optimizer_params=OPT,
          arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
          aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    return {k: v.asnumpy() for k, v in m.get_params()[0].items()}


def test_sync_free_loop_equals_synchronous_loop(monkeypatch):
    """MXTPU_ASYNC_DEPTH=2 with the device feed trains exactly as depth
    1 without it, and the feed and the window are really used."""
    sym, arg, aux, x, y = _resnet_case(2, 3)
    runs = []
    for depth, feed in (('2', '1'), ('1', '0')):
        monkeypatch.setenv('MXTPU_ASYNC_DEPTH', depth)
        monkeypatch.setenv('MXTPU_DEVICE_FEED', feed)
        tmx.instrument.reset_metrics()
        metric = tmx.metric.create('acc')
        runs.append((_fit_params(sym, arg, aux, x, y, 2, metric),
                     metric.get()[1], tmx.instrument.metrics_snapshot()))
    (p2, m2, s2), (p1, m1, s1) = runs
    for k in p1:
        np.testing.assert_array_equal(p2[k], p1[k], err_msg=k)
    assert m2 == m1
    assert s2['counters']['io.h2d_prefetch_bytes'] > 0
    assert 'io.h2d_prefetch_bytes' not in s1['counters']
    assert s2['gauges']['engine.inflight_peak'] == 2
    assert s1['gauges']['engine.inflight_peak'] == 1
    assert s2['counters']['io.batches'] == s1['counters']['io.batches'] == 6


def test_fit_with_a_host_metric_reads_each_steps_outputs(monkeypatch):
    """A metric with no device form is updated from each step's outputs
    on the host (before the next step is launched): the same value at
    depth 2 as at depth 1."""
    class HostAcc(tmx.metric.EvalMetric):
        def __init__(self):
            super().__init__('host_acc')

        def update(self, labels, preds):
            p = preds[0].asnumpy().argmax(1)
            self.sum_metric += float((p == labels[0].asnumpy()).sum())
            self.num_inst += len(p)

    sym, arg, aux, x, y = _resnet_case(2, 3)
    got = []
    for depth in ('2', '1'):
        monkeypatch.setenv('MXTPU_ASYNC_DEPTH', depth)
        metric = HostAcc()
        _fit_params(sym, arg, aux, x, y, 2, metric)
        got.append(metric.get())
    assert got[0] == got[1] and got[0][0] == 'host_acc'


def test_make_train_step_on_the_cpu_updates_the_callers_tensors():
    """On the CPU the raw-API step runs eagerly on the caller's own
    tensors and captures nothing."""
    from mxnet_tpu_torch.parallel import train_step as tts
    sym = tmodels.get_symbol('transformer_lm', **LM_CFG)
    t = LM_CFG['seq_len']
    arg, _ = convert.random_params(
        sym, {'data': (2, t), 'softmax_label': (2, t)}, 0, init='normal')
    params = {k: torch.from_numpy(v.copy()) for k, v in arg.items()}
    toks = np.random.RandomState(1).randint(0, 200, (2, t))
    batch = {'data': torch.tensor(toks, dtype=torch.float32),
             'softmax_label': torch.tensor((toks + 1) % 200,
                                           dtype=torch.float32)}
    step = tts.make_train_step(sym, tts.make_sgd_momentum(lr=0.1),
                               ('data', 'softmax_label'))
    before = {k: v.clone() for k, v in params.items()}
    outs, got, _, _ = step(params, {}, tts.sgd_momentum_init(params), batch)
    assert got is params and step.graphs == {}
    assert any(not torch.equal(before[k], params[k]) for k in params)
    assert outs[0].shape == (2 * t, 200)


def test_metric_accumulator_is_folded_and_zeroed_in_place():
    """A captured step holds the accumulator's address: folds add into
    it, a drain reads and zeroes it, reset zeroes it; it is never
    replaced."""
    m = tmx.metric.create('acc')
    p = torch.tensor([[0.2, 0.8], [0.6, 0.4]])
    acc = m._accumulators('cpu')[0]
    n = m._fold_device(torch.tensor([1.0, 1.0]), p)
    assert n == 2 and float(acc) == 1.0
    m._fold_count(n)
    m.device_fold(torch.tensor([0.0, 0.0]), p)
    assert m.get() == ('accuracy', 0.5)
    assert m._dev_sum is acc and float(acc) == 0.0
    m._fold_count(m._fold_device(torch.tensor([1.0, 0.0]), p))
    m.reset()
    assert m._dev_sum is acc and float(acc) == 0.0
    assert m.get()[1] != m.get()[1]        # nan: nothing counted


def test_recorded_counts_apply_per_replay():
    """What a capture records (on its own thread) is applied on each
    replay; another thread's counts made meanwhile are not recorded."""
    import threading
    from mxnet_tpu_torch.ops import fused
    k = fused.fused_scale_bias_dot
    n0, r0 = k.launches, k.launches_by_route['sm90']
    c0 = tmx.instrument.counter_value('test.capture_counter')
    with tmx.instrument.recording() as rec:
        tmx.instrument.count_launch(k, 'sm90')
        tmx.instrument.inc('test.capture_counter', 2)
        t = threading.Thread(target=tmx.instrument.inc,
                             args=('test.capture_counter',))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert rec == {(k, 'sm90'): 1, 'test.capture_counter': 2}
    assert (k.launches, k.launches_by_route['sm90']) == (n0, r0)
    assert tmx.instrument.counter_value('test.capture_counter') == c0 + 1
    for _ in range(3):
        tmx.instrument.apply_counts(rec)
    assert (k.launches, k.launches_by_route['sm90']) == (n0 + 3, r0 + 3)
    assert tmx.instrument.counter_value('test.capture_counter') == c0 + 7


@pytest.mark.parametrize('capturing', [True, False])
def test_capture_recording_takes_a_capturing_threads_counts(monkeypatch,
                                                            capturing):
    """A capture's recording also takes the launches of another thread
    whose current stream is capturing (the autograd thread that runs the
    captured backward, a mirrored forward's recompute in it); a thread
    that is not capturing counts as before."""
    import threading
    from mxnet_tpu_torch.ops import fused
    k = fused.fused_scale_bias_dot
    seen = threading.local()
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: getattr(seen, 'capturing', False))
    n0 = k.launches

    def backward_thread():
        seen.capturing = capturing
        tmx.instrument.count_launch(k, 'sm90')

    with tmx.instrument.recording(capture=True) as rec:
        tmx.instrument.count_launch(k, 'sm90')
        t = threading.Thread(target=backward_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert rec == {(k, 'sm90'): 2 if capturing else 1}
    assert k.launches == n0 + (0 if capturing else 1)
    with tmx.instrument.recording() as plain:
        t = threading.Thread(target=backward_thread)
        t.start()
        t.join(timeout=30)
    assert plain == {}


def test_lr_tensor_matches_float_lr():
    """The functional update with the lr in a 0-dim tensor equals the
    one with the same lr as a float (the captured step's form)."""
    opt = tmx.optimizer.create('sgd', momentum=0.9, wd=0.01,
                               param_idx2name={0: 'w', 1: 'b'})
    opt.set_lr_mult({'b': 2.0})
    fo = opt.make_functional(['w', 'b'], {'w': 0, 'b': 1})
    out = []
    for lr in (0.05, torch.tensor(0.05)):
        r = np.random.RandomState(0)
        p = {n: torch.from_numpy(r.randn(3, 2).astype(np.float32))
             for n in ('w', 'b')}
        g = {n: torch.ones(3, 2) for n in p}
        s = fo.init(p)
        fo.update(p, g, s, lr)
        fo.update(p, g, s, lr)
        out.append(p)
    for n in ('w', 'b'):
        assert torch.equal(out[0][n], out[1][n])


# ---------------------------------------------------------------------------
# on the card: captured against eager
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _close(got, want, what):
    """Within chip_smoke.py's train-parity bound."""
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                   err_msg='%s %s' % (what, k))


def _launch_counts():
    from mxnet_tpu_torch.ops import attention, fused, fused_conv
    return {k.__name__: (k.launches, dict(getattr(k, 'launches_by_route',
                                                  {})))
            for k in (fused.fused_bn_relu, fused.fused_scale_bias_dot,
                      fused.fused_dot_epilogue,
                      fused_conv.fused_scale_bias_conv3x3,
                      attention.flash_attention, tmx.rtc.Rtc)}


def _gpu_fit(sym, arg, aux, x, y, batch, naive, dtype=torch.bfloat16,
             **fit_kw):
    engine.set_engine_type('NaiveEngine' if naive else
                           'ThreadedEnginePerDevice')
    try:
        m = tmx.Module(sym, context=tmx.gpu(0), compute_dtype=dtype)
        m.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
              optimizer='sgd', optimizer_params=OPT,
              arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
              aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
              **fit_kw)
        torch.cuda.synchronize()
    finally:
        engine.set_engine_type('ThreadedEnginePerDevice')
    return m


@pytest.mark.cuda
def test_fit_step_captured_matches_eager(dev):
    """A bf16 narrow ResNet through Module.fit: one graph, replayed after
    the first step, the same kernels launched per step (the sm90 routes
    inside the graph), parameters as the eager fit's."""
    sym, arg, aux, x, y = _resnet_case(8, 4)
    runs = []
    for naive in (False, True):
        before = _launch_counts()
        hits = tmx.instrument.counter_value('executor.cache_hits')
        m = _gpu_fit(sym, arg, aux, x, y, 8, naive)
        after = _launch_counts()
        runs.append((m, {k: (after[k][0] - before[k][0],
                         {r: n - before[k][1][r]
                          for r, n in after[k][1].items()})
                     for k in after},
                     tmx.instrument.counter_value('executor.cache_hits')
                     - hits))
    (cm, cl, chits), (em, el, ehits) = runs
    (cap,) = cm._graphs.values()
    assert cap.captured and cap.replays == 3
    assert chits == 3 and ehits == 0
    # launches per step by kernel and route: the same captured or eager
    assert cl == el
    for name in ('fused_scale_bias_dot', 'fused_scale_bias_conv3x3'):
        assert cl[name][0] == 4 * cap.launches[name] > 0
    (eg,) = em._graphs.values()
    assert eg.skip == 'NaiveEngine' and not eg.captured
    _close({k: v.asnumpy() for k, v in cm.get_params()[0].items()},
           {k: v.asnumpy() for k, v in em.get_params()[0].items()}, 'param')


def _lm_case(dev, rows=4):
    from mxnet_tpu_torch.parallel import train_step as tts
    sym = tmodels.get_symbol('transformer_lm', **LM_CFG)
    t, v = LM_CFG['seq_len'], LM_CFG['vocab_size']
    arg, _ = convert.random_params(
        sym, {'data': (rows, t), 'softmax_label': (rows, t)}, 0,
        init='normal')
    toks = np.random.RandomState(1).randint(0, v, (3, rows, t))
    batches = [{'data': torch.tensor(b, dtype=torch.float32, device=dev),
                'softmax_label': torch.tensor((b + 1) % v,
                                              dtype=torch.float32,
                                              device=dev)} for b in toks]
    return tts, sym, arg, batches


@pytest.mark.cuda
def test_lm_train_step_captured_matches_eager(dev):
    tts, sym, arg, batches = _lm_case(dev)
    got = []
    for naive in (False, True):
        engine.set_engine_type('NaiveEngine' if naive else
                               'ThreadedEnginePerDevice')
        step = tts.make_train_step(sym, tts.make_sgd_momentum(lr=0.1),
                                   ('data', 'softmax_label'),
                                   compute_dtype=torch.bfloat16)
        params = {k: torch.tensor(v, device=dev) for k, v in arg.items()}
        state = tts.sgd_momentum_init(params)
        outs = []
        for b in batches:
            o, params, _, state = step(params, {}, state, b)
            outs.append(o[0].float().cpu().numpy())
        got.append(({k: v.cpu().numpy() for k, v in params.items()}, outs,
                    step.graphs))
    (cp, co, cg), (ep, eo, eg) = got
    assert len(cg) == 1 and list(cg.values())[0][0].captured and eg == {}
    for a, b in zip(co, eo):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
    _close(cp, ep, 'param')


def _predictor(dev_type, naive):
    sym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(sym, {'data': (8, 3, 64, 64)}, 0)
    engine.set_engine_type('NaiveEngine' if naive else
                           'ThreadedEnginePerDevice')
    try:
        return tmx.Predictor(sym.tojson(), convert.params_from_numpy(
            arg, aux, 'cuda:0' if dev_type == 'gpu' else 'cpu'),
            {'data': (8, 3, 64, 64)}, dev_type=dev_type, pad_to_bucket=True)
    finally:
        engine.set_engine_type('ThreadedEnginePerDevice')


@pytest.mark.cuda
def test_predictor_bucket_captured_matches_eager(dev):
    """warm_buckets captures every bucket; a forward's returned arrays
    survive the next forward; outputs equal the eager Predictor's."""
    x = np.random.default_rng(3).standard_normal((8, 3, 64, 64),
                                                 dtype=np.float32)
    cap, eager = _predictor('gpu', False), _predictor('gpu', True)
    assert cap.warm_buckets(8) == [1, 2, 4, 8]
    assert all(e._forward_graph.captured
               for e in cap._bucket_execs.values())
    first = cap.forward(data=x[:3])[0]
    held = first.asnumpy().copy()
    cap.forward(data=x[3:8])
    assert np.array_equal(first.asnumpy(), held)
    for rows in ((0, 3), (3, 8), (1, 2)):
        part = x[rows[0]:rows[1]]
        cap.forward(data=part)
        eager.forward(data=part)
        np.testing.assert_allclose(cap.get_output(0), eager.get_output(0),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_dropout_draws_a_new_mask_on_each_replay(dev):
    """A graph holding a random node registers the device generator with
    the graph (each replay draws anew), or, where this PyTorch cannot,
    stays eager by rule."""
    from mxnet_tpu_torch.executor import _build_graph_fn
    drop = tmx.sym.Dropout(tmx.sym.Variable('data'), p=0.5, name='drop')
    fn = _build_graph_fn(drop, True)
    x = torch.ones(4096, device=dev)
    skip = compile_cache.capture_skip_reason(dev, drop)
    gens = [tmx.random.generator(dev)] if skip is None else []
    cap = compile_cache.CapturedStep(
        'dropout', lambda: fn({'data': x}, {})[0], dev, skip=skip,
        generators=gens)
    masks = [cap.run()[0].clone() for _ in range(3)]
    if skip is not None:
        assert skip == 'random'
        return
    assert cap.captured
    assert not torch.equal(masks[1], masks[2])
    assert 0.4 < float((masks[2] == 0).float().mean()) < 0.6


@pytest.mark.cuda
def test_host_sync_under_capture_raises_naming_the_node(dev):
    name = '_capture_test_host_sync'
    if name not in registry.list_ops():
        # a host read of a device value (shape inference's meta tensors
        # have none)
        registry.register_simple(name, lambda x: x * float(x.sum().item())
                                 if x.is_cuda else x)
    net = getattr(tmx.sym, name)(tmx.sym.Variable('data'), name='syncer')
    exe = net.simple_bind(tmx.gpu(0), grad_req='null', data=(4, 4))
    exe.enable_capture()
    with pytest.raises(tmx.MXNetError, match='syncer'):
        exe.forward(is_train=False)


@pytest.mark.cuda
def test_lr_schedule_changes_the_captured_update(dev):
    """An lr scheduler that lowers the lr at step 3 changes the captured
    step's update from step 3 on (the lr is a tensor the graph reads, not
    a constant recorded at capture) exactly as it changes the eager one."""
    sym, arg, aux, x, y = _resnet_case(8, 4)

    def fit(naive, sched):
        snaps = []
        opt = dict(OPT)
        if sched:
            opt['lr_scheduler'] = tmx.lr_scheduler.MultiFactorScheduler(
                [2], 0.1)
        engine.set_engine_type('NaiveEngine' if naive else
                               'ThreadedEnginePerDevice')
        try:
            m = tmx.Module(sym, context=tmx.gpu(0))
            m.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                  optimizer='sgd', optimizer_params=opt,
                  arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                  aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
                  batch_end_callback=lambda p: snaps.append(
                      {k: v.asnumpy()
                       for k, v in m.get_params()[0].items()}))
        finally:
            engine.set_engine_type('ThreadedEnginePerDevice')
        return snaps

    cap, eager, flat = fit(False, True), fit(True, True), fit(False, False)
    for a, b in zip(cap, eager):
        _close(a, b, 'param')
    for step in (0, 1):
        _close(cap[step], flat[step], 'param before the lr change')

    def update(snaps, step):
        return np.concatenate([(snaps[step][k] - snaps[step - 1][k]).ravel()
                               for k in sorted(snaps[step])])
    for step in (2, 3):
        d_cap, d_flat = update(cap, step), update(flat, step)
        assert np.linalg.norm(d_cap - d_flat) > 0.1 * np.linalg.norm(d_flat)


@pytest.mark.cuda
def test_host_metric_reads_each_replays_outputs(dev):
    """With two steps in flight, a metric with no device form reads each
    step's outputs (the graph's, which the next replay overwrites) on
    the host before the next step is launched: the same value as the
    eager fit's."""
    class HostCE(tmx.metric.EvalMetric):
        def __init__(self):
            super().__init__('host_ce')

        def update(self, labels, preds):
            p = preds[0].asnumpy()
            y = labels[0].asnumpy().astype(np.int64)
            self.sum_metric += float(-np.log(
                p[np.arange(len(y)), y] + 1e-8).sum())
            self.num_inst += len(y)

    sym, arg, aux, x, y = _resnet_case(8, 4)
    got = []
    for naive in (False, True):
        metric = HostCE()
        m = _gpu_fit(sym, arg, aux, x, y, 8, naive, eval_metric=metric)
        assert naive or list(m._graphs.values())[0].replays == 3
        got.append(metric.get()[1])
    assert got[0] == pytest.approx(got[1], rel=1e-3)


@pytest.mark.cuda
def test_set_params_drops_the_graphs(dev):
    """After set_params the module holds no graph, and its next step
    trains the new values: as the same sequence does under NaiveEngine."""
    sym, arg, aux, x, y = _resnet_case(8, 3)
    new = {k: (v * 0.5).astype(np.float32) for k, v in arg.items()}
    batch = tmx.io.DataBatch([tmx.nd.array(x[16:])], [tmx.nd.array(y[16:])])
    got = []
    for naive in (False, True):
        m = _gpu_fit(sym, arg, aux, x[:16], y[:16], 8, naive)
        assert m._graphs and all(c.captured != naive
                                 for c in m._graphs.values())
        m.set_params({k: tmx.nd.array(v) for k, v in new.items()},
                     {k: tmx.nd.array(v) for k, v in aux.items()})
        assert m._graphs == {}
        engine.set_engine_type('NaiveEngine' if naive else
                               'ThreadedEnginePerDevice')
        m._fit_step(batch, None)
        m._fit_step(batch, None)
        engine.set_engine_type('ThreadedEnginePerDevice')
        assert naive or list(m._graphs.values())[0].replays == 1
        got.append({k: v.asnumpy() for k, v in m.get_params()[0].items()})
    _close(got[0], got[1], 'param')


def _custom_mid_symbol():
    fc = tmx.sym.FullyConnected(tmx.sym.Variable('data'), num_hidden=8,
                                name='fc')
    sq = tmx.sym.Custom(tmx.sym.Activation(fc, act_type='tanh', name='t'),
                        op_type='sqr_capture', name='sq')
    fc2 = tmx.sym.FullyConnected(sq, num_hidden=8, name='fc2')
    return tmx.sym.SoftmaxOutput(fc2, name='softmax')


@pytest.mark.cuda
@pytest.mark.parametrize('make', [_custom_symbol, _custom_mid_symbol],
                         ids=['before_head', 'mid'])
def test_custom_graph_is_captured_in_segments(dev, make):
    """A Custom node before the loss head, and one deeper in the middle
    of the graph: the fit step is captured in segments (three graphs:
    the first segment's forward, the second's forward and backward, the
    first's backward with the update; the user's code between them),
    replayed after the first step, and its parameters are bit for bit
    those of the eager (NaiveEngine) fit."""
    x = np.random.default_rng(0).standard_normal((12, 6)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 8, 12).astype(np.float32)
    arg = {k: v for k, v in convert.random_params(
        make(), {'data': (4, 6)}, 0)[0].items()}
    got = []
    for naive in (False, True):
        engine.set_engine_type('NaiveEngine' if naive else
                               'ThreadedEnginePerDevice')
        try:
            m = tmx.Module(make(), context=tmx.gpu(0))
            m.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                  optimizer='sgd', optimizer_params=OPT,
                  arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
        finally:
            engine.set_engine_type('ThreadedEnginePerDevice')
        (cap,) = m._graphs.values()
        assert isinstance(cap, compile_cache.StagedStep)
        if naive:
            assert cap.skip == 'NaiveEngine' and not cap.captured
        else:
            assert cap.skip is None and cap.captured
            assert len(cap.graphs) == 3 and cap.replays == 2
        got.append({k: v.asnumpy() for k, v in m.get_params()[0].items()})
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k


def _bucket_module(ctx, arg):
    cfg = dict(vocab_size=LM_CFG['vocab_size'], num_embed=64, num_heads=4,
               num_layers=1, max_seq_len=32)
    mod = tmx.mod.BucketingModule(tlm.sym_gen_bucketing(**cfg),
                                  default_bucket_key=32, context=ctx)
    mod.bind(data_shapes=[('data', (4, 32))],
             label_shapes=[('softmax_label', (4, 32))])
    mod.init_params(arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
    mod.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    return mod


@pytest.mark.cuda
def test_buckets_share_parameters_and_keep_their_outputs(dev):
    """Alternating buckets replay their own graphs over the default
    bucket's tensors (one pool); a bucket's outputs survive another
    bucket's replay; the parameters match the eager run's."""
    cfg = dict(vocab_size=LM_CFG['vocab_size'], num_embed=64, num_heads=4,
               num_layers=1, max_seq_len=32)
    arg = convert.random_params(tlm.sym_gen_bucketing(**cfg)(32)[0],
                                {'data': (4, 32), 'softmax_label': (4, 32)},
                                0, init='normal')[0]
    rng = np.random.RandomState(4)
    order = (32, 16, 32, 16, 32, 16)
    batches = []
    for t in order:
        toks = rng.randint(0, cfg['vocab_size'], (4, t)).astype(np.float32)
        batches.append(tmx.io.DataBatch(
            [tmx.nd.array(toks)],
            [tmx.nd.array((toks + 1) % cfg['vocab_size'])], bucket_key=t,
            provide_data=[('data', (4, t))],
            provide_label=[('softmax_label', (4, t))]))
    results = []
    for naive in (False, True):
        engine.set_engine_type('NaiveEngine' if naive else
                               'ThreadedEnginePerDevice')
        mod = _bucket_module(tmx.gpu(0), arg)
        metric = tmx.metric.create('acc')
        held = None
        for i, b in enumerate(batches):
            mod._fit_step(b, metric)
            if i == 3:          # bucket 16's first replay
                out16 = mod._buckets[16].get_outputs()[0]
                held = out16.asnumpy().copy()
            if i == 4 and not naive:
                # bucket 32's replay leaves bucket 16's outputs alone
                assert np.array_equal(out16.asnumpy(), held)
        torch.cuda.synchronize()
        if not naive:
            d = mod._buckets[32]._exec_group.execs[0]
            for m in mod._buckets.values():
                ex = m._exec_group.execs[0]
                assert all(c.captured for c in m._graphs.values())
                for n in d.grad_dict:
                    assert ex.arg_dict[n].handle.data_ptr() == \
                        d.arg_dict[n].handle.data_ptr()
            assert mod._buckets[16]._family_pool() == \
                mod._buckets[32]._family_pool()
        results.append(({k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()}, metric.get()[1]))
    engine.set_engine_type('ThreadedEnginePerDevice')
    _close(results[0][0], results[1][0], 'param')
    assert results[0][1] == pytest.approx(results[1][1])


@pytest.mark.cuda
def test_warm_started_fit_equals_cold_fit_and_window_overlaps(dev):
    sym, arg, aux, x, y = _resnet_case(8, 4)
    tmx.instrument.reset_metrics()
    warm = _gpu_fit(sym, arg, aux, x, y, 8, False, warm_start=True)
    assert tmx.instrument.metrics_snapshot()['gauges'][
        'engine.inflight_peak'] == 2
    assert tmx.instrument.counter_value('compile.traces') == 1
    # every step of the warm fit replays the graph captured before it
    assert tmx.instrument.counter_value('executor.cache_hits') == 4
    cold = _gpu_fit(sym, arg, aux, x, y, 8, False)
    _close({k: v.asnumpy() for k, v in warm.get_params()[0].items()},
           {k: v.asnumpy() for k, v in cold.get_params()[0].items()},
           'param')
