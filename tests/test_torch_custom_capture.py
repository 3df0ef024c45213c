"""A step whose graph has ``Custom`` nodes, captured in segments
(``executor.SegmentPlan``, ``FitStep.stages``,
``compile_cache.StagedStep``), on the CPU: the partition, the staged
step run eagerly stage by stage against the one-piece eager step (bit
for bit), the user's forward and backward called once per step, and
``Module.fit`` through the staged step against the JAX package's fit
(rtol 1e-5, atol 1e-6; one float32 graph in both, only the summation
order of the two packages' kernels differs).

Two graphs: an MLP with a ``Custom`` square in the middle (tanh ->
Custom -> FullyConnected -> SoftmaxOutput) and the ``need_top_grad=False``
softmax head of ``tests/test_torch_operator.py`` (numpy in the JAX
package, ``nd.*`` in the port).  On the card the same stages are
recorded as CUDA graphs (``tests/test_torch_capture.py``,
``chip_smoke.py``'s custom-train phase)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import health as j_health
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import operator as jop
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import compile_cache
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import operator as top
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch.executor import SegmentPlan
from mxnet_tpu_torch.parallel import train_step as tts

CALLS = {'forward': 0, 'backward': 0}
KNOBS = ('MXTPU_FUSE', 'MXTPU_HEALTH_SENTINELS', 'MXTPU_PERFWATCH',
         'MXTPU_IOWATCH', 'MXNET_BACKWARD_DO_MIRROR', 'MXTPU_COMPILE_CACHE')


def reset_planes():
    """Both packages' process-global plane state back to off."""
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


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    reset_planes()
    yield
    reset_planes()


def _register(pkg, opmod):
    @opmod.register('sqr_cc')
    class SqrProp(opmod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(opmod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if pkg is tmx:
                CALLS['forward'] += 1
            self.assign(out_data[0], req[0], pkg.nd.square(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            if pkg is tmx:
                CALLS['backward'] += 1
            self.assign(in_grad[0], req[0], out_grad[0] * in_data[0] * 2.0)

    @opmod.register('softmax_head_cc')
    class SoftmaxProp(opmod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NdSoftmax() if pkg is tmx else NumpySoftmax()

    class NumpySoftmax(opmod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], pkg.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(np.int32)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], pkg.nd.array(y))

    class NdSoftmax(opmod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS['forward'] += 1
            x = in_data[0]
            e = pkg.nd.exp(x - pkg.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / pkg.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            CALLS['backward'] += 1
            y = out_data[0]
            hot = pkg.nd.one_hot(in_data[1], depth=y.shape[1])
            self.assign(in_grad[0], req[0], y - hot)


_register(mx, jop)
_register(tmx, top)


def _mid(pkg):
    fc = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=12,
                                name='fc1')
    t = pkg.sym.Activation(fc, act_type='tanh', name='t1')
    sq = pkg.sym.Custom(t, op_type='sqr_cc', name='sq')
    fc2 = pkg.sym.FullyConnected(sq, num_hidden=5, name='fc2')
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _head(pkg):
    fc = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=12,
                                name='fc1')
    t = pkg.sym.Activation(fc, act_type='tanh', name='t1')
    fc2 = pkg.sym.FullyConnected(t, num_hidden=5, name='fc2')
    return pkg.sym.Custom(fc2, pkg.sym.Variable('softmax_label'),
                          op_type='softmax_head_cc', name='softmax')


GRAPHS = {'mid': _mid, 'head': _head}


def _case(seed=0, rows=4, steps=3):
    rng = np.random.RandomState(seed)
    params = {'fc1_weight': rng.randn(12, 7).astype(np.float32) * 0.4,
              'fc1_bias': rng.randn(12).astype(np.float32) * 0.1,
              'fc2_weight': rng.randn(5, 12).astype(np.float32) * 0.4,
              'fc2_bias': rng.randn(5).astype(np.float32) * 0.1}
    x = rng.randn(rows * steps, 7).astype(np.float32)
    y = rng.randint(0, 5, rows * steps).astype(np.float32)
    return params, x, y


def test_segment_plan_cuts_at_the_custom_nodes():
    """mid: [fc1, t1] | sq | [fc2, softmax], t1's output exported to the
    Custom and the Custom's output read by the last segment; head:
    [fc1, t1, fc2] | softmax | [] (an empty last segment)."""
    mid = SegmentPlan(_mid(tmx))
    kinds = [(k, [n.name for n in x] if k == 'seg' else x.name)
             for k, x in mid.pieces]
    assert kinds == [('seg', ['fc1', 't1']), ('custom', 'sq'),
                     ('seg', ['fc2', 'softmax'])]
    assert mid.variables[0] == ['data', 'fc1_weight', 'fc1_bias']
    assert len(mid.exports[0]) == 1 and len(mid.inputs[2]) == 1
    assert mid.exports[1] == mid.inputs[2]
    head = SegmentPlan(_head(tmx))
    assert [(k, [n.name for n in x] if k == 'seg' else x.name)
            for k, x in head.pieces] == [
        ('seg', ['fc1', 't1', 'fc2']), ('custom', 'softmax'), ('seg', [])]
    assert head.exports[1] == [head.exports[1][0]]      # the output


def _run(graph, staged, steps=3, metric=None, health=None):
    params0, x, y = _case()
    params = {k: torch.tensor(v) for k, v in params0.items()}
    opt = topt.create('sgd', learning_rate=0.1, momentum=0.9, wd=1e-4)
    fo = opt.make_functional(list(params), {k: i for i, k in
                                            enumerate(params)})
    state = fo.init(params)
    m = tmx.metric.create(metric) if metric else None
    step = tts.make_fit_step(GRAPHS[graph](tmx), fo, data_names=('data',),
                             metric=m, metric_label='softmax_label'
                             if m else None, health_action=health)
    hstate = None
    if health:
        mon = t_health.HealthMonitor(action=health)
        hstate = mon.device_state(torch.device('cpu'))
    batch = {'data': torch.zeros(4, 7), 'softmax_label': torch.zeros(4)}
    lr = torch.tensor(0.1)
    cap = step.capture(params, {}, {}, state, batch, lr,
                       health_state=hstate) if staged else None
    outs = []
    for i in range(steps):
        batch['data'].copy_(torch.from_numpy(x[4 * i:4 * i + 4]))
        batch['softmax_label'].copy_(torch.from_numpy(y[4 * i:4 * i + 4]))
        if staged:
            o = cap.run()
            if m is not None:
                m._fold_count(step.metric_count)
        else:
            o = step(params, {}, {}, state, batch, lr, hstate)
        outs.append(o[0].clone())
    res = {k: v.clone() for k, v in params.items()}
    res.update({'mom_' + k: v.clone() for k, v in state.items()})
    for i, o in enumerate(outs):
        res['out%d' % i] = o
    if m is not None:
        res['metric'] = torch.tensor(m.get()[1])
    if hstate is not None:
        res.update({'health_%d' % i: t.clone()
                    for i, t in enumerate(compile_cache.step_tensors(hstate))})
    return res, cap


@pytest.mark.parametrize('graph', ['mid', 'head'])
@pytest.mark.parametrize('metric,health', [(None, None), ('acc', None),
                                           ('acc', 'skip_update')])
def test_staged_step_equals_the_one_piece_step_bit_for_bit(graph, metric,
                                                           health):
    """Three SGD-momentum steps, the metric folded and the health probe
    on: parameters, momentum, outputs, the metric and the health state
    equal the one-piece eager step's exactly; the user's forward and
    backward run once per step in both."""
    CALLS.update(forward=0, backward=0)
    one, _ = _run(graph, False, metric=metric, health=health)
    assert CALLS == {'forward': 3, 'backward': 3}
    staged, cap = _run(graph, True, metric=metric, health=health)
    assert CALLS == {'forward': 6, 'backward': 6}
    assert isinstance(cap, compile_cache.StagedStep) and cap.skip == 'cpu'
    kinds = ['graph' if isinstance(s, compile_cache.CapturedStep) else 'host'
             for s in cap.stages]
    assert kinds == {'mid': ['graph', 'host', 'graph', 'host', 'graph'],
                     'head': ['graph', 'host', 'host', 'graph']}[graph]
    assert set(one) == set(staged)
    for k in one:
        assert torch.equal(one[k], staged[k]), k


def _fit(pkg, graph, mirror=False):
    params, x, y = _case(seed=1, steps=3)
    m = pkg.mod.Module(GRAPHS[graph](pkg), context=pkg.cpu())
    m.fit(pkg.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
          optimizer='sgd', eval_metric='acc',
          optimizer_params={'learning_rate': 0.1, 'momentum': 0.9,
                            'wd': 1e-4},
          arg_params={k: pkg.nd.array(v) for k, v in params.items()})
    return m


@pytest.mark.parametrize('graph', ['mid', 'head'])
def test_segmented_fit_matches_jax(graph):
    """Module.fit, three steps: the port's step is a StagedStep run
    eagerly segment by segment; its parameters and its predictions
    match the JAX package's fit (user code in jax.pure_callback) within
    rtol 1e-5, atol 1e-6; the user's code ran once per step."""
    CALLS.update(forward=0, backward=0)
    t = _fit(tmx, graph)
    assert CALLS == {'forward': 3, 'backward': 3}
    (cap,) = t._graphs.values()
    assert isinstance(cap, compile_cache.StagedStep)
    j = _fit(mx, graph)
    params0 = _case(seed=1)[0]
    (ta, _), (ja, _) = t.get_params(), j.get_params()
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.allclose(ta[k].asnumpy(), params0[k])
    x = _case(seed=1)[1][:4]
    outs = [m.predict(pkg.io.NDArrayIter(x, np.zeros(4, np.float32),
                                         batch_size=4)).asnumpy()
            for pkg, m in ((tmx, t), (mx, j))]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_mirror_keeps_a_custom_step_in_one_piece(monkeypatch):
    """Under MXNET_BACKWARD_DO_MIRROR a Custom graph's step is one eager
    piece (the recompute runs across the user's code); on a card it
    would say why."""
    monkeypatch.setenv('MXNET_BACKWARD_DO_MIRROR', '1')
    t = _fit(tmx, 'mid')
    (cap,) = t._graphs.values()
    assert isinstance(cap, compile_cache.CapturedStep)
    assert compile_cache.capture_skip_reason(
        torch.device('cuda', 0), t._fused.program) == \
        'Custom under the mirror'


@pytest.mark.parametrize('graph', ['mid', 'head'])
def test_staged_forward_equals_the_plain_forward(graph):
    """An executor with enable_capture and make_eval_step run a Custom
    graph's inference forward through staged_forward: the same outputs
    as the plain forward, the user's forward once per call."""
    params, x, y = _case()
    sym = GRAPHS[graph](tmx)
    ex = sym.simple_bind(tmx.cpu(), data=(4, 7), softmax_label=(4,),
                         grad_req='null')
    for k, v in params.items():
        ex.arg_dict[k][:] = tmx.nd.array(v)
    ex.arg_dict['data'][:] = tmx.nd.array(x[:4])
    ex.arg_dict['softmax_label'][:] = tmx.nd.array(y[:4])
    plain = ex.forward(is_train=False)[0].asnumpy()
    ex.enable_capture()
    CALLS.update(forward=0, backward=0)
    staged = ex.forward(is_train=False)[0].asnumpy()
    assert isinstance(ex._forward_graph, compile_cache.StagedStep)
    assert CALLS['forward'] == 1
    np.testing.assert_array_equal(plain, staged)
    step = tts.make_eval_step(sym)
    outs = step({k: torch.tensor(v) for k, v in params.items()}, {},
                {'data': torch.tensor(x[:4]),
                 'softmax_label': torch.tensor(y[:4])})
    np.testing.assert_array_equal(outs[0].numpy(), plain)
