"""Model parallelism (``group2ctx``) in the port against the JAX
package's executor on the CPU: the cases of ``tests/test_model_parallel.py``
and ``tests/test_multi_device_exec.py`` on the same numpy inputs in both
packages (the JAX side's ``tpu(i)`` contexts are the port's ``cpu(i)``),
and the model-parallel LSTM LM of ``examples/model_parallel_lstm.py`` at
a narrow width.  Outputs and gradients within rtol 1e-5 (atol 1e-6)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.rnn.rnn_cell import LSTMCell as JLSTMCell
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.rnn.rnn_cell import LSTMCell as TLSTMCell

TOL = dict(rtol=1e-5, atol=1e-6)


def _ctx(pkg, i):
    return pkg.tpu(i) if pkg is jmx else pkg.cpu(i)


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


def _chain(pkg):
    n = 2
    data1 = pkg.sym.Variable('data1')
    data2 = pkg.sym.Variable('data2')
    with pkg.AttrScope(ctx_group='dev1'):
        net = data1 * 2.0
        net = net + data2
    with pkg.AttrScope(ctx_group='dev2'):
        out = net + 1.0
    nd = pkg.nd
    arr = [nd.array(np.ones((n, n), np.float32)),
           nd.array(np.full((n, n), 3.0, np.float32))]
    grads = [nd.zeros((n, n)), nd.zeros((n, n))]
    ex = out.bind(_ctx(pkg, 0), args={'data1': arr[0], 'data2': arr[1]},
                  args_grad={'data1': grads[0], 'data2': grads[1]},
                  group2ctx={'dev1': _ctx(pkg, 0), 'dev2': _ctx(pkg, 1)})
    res = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(nd.array(np.ones((n, n), np.float32)))
    return res, [g.asnumpy() for g in grads]


def test_chain_group2ctx():
    (res, grads), (jres, jgrads) = _chain(tmx), _chain(jmx)
    assert np.allclose(res, 2 * 1 + 3 + 1)
    assert np.allclose(grads[0], 2.0) and np.allclose(grads[1], 1.0)
    _close(res, jres)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


def _mlp(pkg, act, hidden, classes):
    data = pkg.sym.Variable('data')
    with pkg.AttrScope(ctx_group='dev1'):
        fc1 = pkg.sym.FullyConnected(data, num_hidden=hidden, name='fc1')
        act1 = pkg.sym.Activation(fc1, act_type=act)
    with pkg.AttrScope(ctx_group='dev2'):
        fc2 = pkg.sym.FullyConnected(act1, num_hidden=classes, name='fc2')
        return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _mlp_train(pkg, steps):
    """The layer-split MLP of ``test_mlp_model_parallel_training``: one
    numpy initialisation, ``steps`` SGD steps; the first step's outputs
    and gradients, the parameters after 3 steps (the two libraries'
    float32 rounding grows with the steps after) and the final
    accuracy."""
    rng = np.random.RandomState(0)
    X = rng.randn(128, 8).astype(np.float32)
    y = np.argmax(X @ rng.randn(8, 2), axis=1).astype(np.float32)
    out = _mlp(pkg, 'relu', 16, 2)
    ex = out.simple_bind(_ctx(pkg, 0), data=(128, 8),
                         group2ctx={'dev1': _ctx(pkg, 0),
                                    'dev2': _ctx(pkg, 1)})
    for k in out.list_arguments():
        v = ex.arg_dict[k]
        if k.endswith('weight'):
            v[:] = rng.rand(*v.shape).astype(np.float32) * 0.1
    ex.arg_dict['data'][:] = X
    ex.arg_dict['softmax_label'][:] = y
    first = None
    names = ('fc1_weight', 'fc1_bias', 'fc2_weight', 'fc2_bias')
    for i in range(steps):
        outs = ex.forward(is_train=True)
        ex.backward()
        if first is None:
            first = (outs[0].asnumpy(),
                     {k: ex.grad_dict[k].asnumpy() for k in names})
        for k in names:
            ex.arg_dict[k][:] = (ex.arg_dict[k] - 0.1 * ex.grad_dict[k]
                                 ).asnumpy()
        if i == 2:
            early = {k: ex.arg_dict[k].asnumpy() for k in names}
    ex.forward(is_train=False)
    acc = (np.argmax(ex.outputs[0].asnumpy(), axis=1) == y).mean()
    return first, early, acc, ex


def test_mlp_model_parallel_training():
    (out, grads), params, acc, ex = _mlp_train(tmx, 60)
    (jout, jgrads), jparams, jacc, _ = _mlp_train(jmx, 60)
    _close(out, jout)
    for k in grads:
        _close(grads[k], jgrads[k])
        _close(params[k], jparams[k])
    assert acc > 0.9 and acc == jacc
    # each gradient lands on its variable's context
    for k in ('fc1_weight', 'fc2_weight'):
        assert ex.grad_dict[k].context == ex.arg_dict[k].context
    assert ex.arg_dict['fc1_weight'].context == tmx.cpu(0)
    assert ex.arg_dict['fc2_weight'].context == tmx.cpu(1)


def _partitioned(pkg, group2ctx):
    rng = np.random.RandomState(1)
    out = _mlp(pkg, 'tanh', 16, 4)
    ex = out.simple_bind(_ctx(pkg, 0), data=(8, 8), group2ctx=group2ctx)
    for k in sorted(ex.arg_dict):
        if k not in ('data', 'softmax_label'):
            v = ex.arg_dict[k]
            v[:] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    ex.arg_dict['data'][:] = rng.randn(8, 8).astype(np.float32)
    return ex


def test_partitioned_forward_matches_eager():
    g2c = {'dev1': tmx.cpu(0), 'dev2': tmx.cpu(1)}
    ex = _partitioned(tmx, g2c)
    from mxnet_tpu_torch.executor import _partition_segments
    segments = _partition_segments(ex._symbol, ex._group2ctx, ex._ctx)
    assert [str(c) for c, _ in segments] == ['cpu(0)', 'cpu(1)']
    res = ex.forward(is_train=False)[0].asnumpy()
    plain = _partitioned(tmx, None).forward(is_train=False)[0].asnumpy()
    jres = _partitioned(jmx, {'dev1': jmx.tpu(0), 'dev2': jmx.tpu(1)}) \
        .forward(is_train=False)[0].asnumpy()
    _close(res, plain)
    _close(res, jres)
    # the monitored path places nodes the same way
    seen = {}
    ex.set_monitor_callback(lambda name, arr: seen.setdefault(
        name, arr.asnumpy()))
    _close(ex.forward(is_train=False)[0].asnumpy(), res)
    assert 'fc2_output' in seen and 'fc1_output' in seen


def test_group2ctx_attr_in_json():
    for pkg in (tmx, jmx):
        with pkg.AttrScope(ctx_group='dev1'):
            a = pkg.sym.Variable('a')
            b = a * 2.0
        import json
        nodes = json.loads(b.tojson())['nodes']
        assert [n for n in nodes if n['name'] == b.name][0]['attrs'][
            'ctx_group'] == 'dev1'


def _ctx_group_bind(pkg, ctx):
    with pkg.AttrScope(ctx_group='stage1'):
        data = pkg.sym.Variable('data')
        fc1 = pkg.sym.FullyConnected(data=data, name='fc1', num_hidden=128)
        act1 = pkg.sym.Activation(data=fc1, name='relu1', act_type='relu')
    stage1 = set(act1.list_arguments())
    with pkg.AttrScope(ctx_group='stage2'):
        fc2 = pkg.sym.FullyConnected(data=act1, name='fc2', num_hidden=64)
        act2 = pkg.sym.Activation(data=fc2, name='relu2', act_type='relu')
        fc3 = pkg.sym.FullyConnected(data=act2, name='fc3', num_hidden=10)
        fc3 = pkg.sym.BatchNorm(fc3)
        mlp = pkg.sym.SoftmaxOutput(data=fc3, name='softmax')
    group2ctx = {'stage1': ctx(1), 'stage2': ctx(2)}
    ex = mlp.simple_bind(ctx(0), group2ctx=group2ctx, data=(1, 200))
    return ex, mlp, stage1, group2ctx


def test_simple_bind_places_each_variable_on_its_group():
    ex, mlp, stage1, g2c = _ctx_group_bind(tmx, tmx.cpu)
    jex, _, _, jg2c = _ctx_group_bind(jmx, jmx.cpu)
    for name, arr in zip(mlp.list_arguments(), ex.arg_arrays):
        want = g2c['stage1' if name in stage1 else 'stage2']
        assert arr.context == want, (name, arr.context)
        assert str(arr.context) == str(jex.arg_dict[name].context)
        if name in ex.grad_dict:
            assert ex.grad_dict[name].context == want
    for name, arr in ex.aux_dict.items():
        assert arr.context == g2c['stage2']
    # shared_exec is accepted, as in the JAX package
    tmx.sym.Variable('x').simple_bind(tmx.cpu(), x=(2,), shared_exec=ex)


def _lstm_lm(pkg, cell_cls, seq_len, vocab, embed, hidden, layers, batch):
    """``examples/model_parallel_lstm.py``'s ``build_lm``."""
    mx = pkg
    data = mx.sym.Variable('data')
    label = mx.sym.Variable('softmax_label')
    with mx.AttrScope(ctx_group='embed'):
        states = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                                  name='embed')
    for i in range(layers):
        with mx.AttrScope(ctx_group='layer%d' % i):
            cell = cell_cls(num_hidden=hidden, prefix='lstm_l%d_' % i)
            begin = cell.begin_state(func=mx.sym.Variable,
                                     shape=(batch, hidden))
            states, _ = cell.unroll(seq_len, inputs=states,
                                    begin_state=begin, merge_outputs=True)
    with mx.AttrScope(ctx_group='decode'):
        pred = mx.sym.Reshape(states, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name='pred')
        label_flat = mx.sym.Reshape(label, shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label_flat, name='softmax')


LSTM = dict(seq_len=5, vocab=20, embed=8, hidden=8, layers=2, batch=4)


def _lstm_steps(pkg, cell_cls, group2ctx, steps=3, lr=0.05):
    net = _lstm_lm(pkg, cell_cls, **LSTM)
    b, t = LSTM['batch'], LSTM['seq_len']
    ex = net.simple_bind(_ctx(pkg, 0), data=(b, t), softmax_label=(b, t),
                         group2ctx=group2ctx, grad_req='write')
    rng = np.random.RandomState(0)
    for name in sorted(ex.arg_dict):
        arr = ex.arg_dict[name]
        if name.endswith(('weight', 'parameters')):
            arr[:] = (rng.rand(*arr.shape) * 0.1).astype(np.float32)
    tokens = np.arange(b * (t + 1)).reshape(b, t + 1) % (LSTM['vocab'] - 1) \
        + 1
    ex.arg_dict['data'][:] = tokens[:, :-1].astype(np.float32)
    ex.arg_dict['softmax_label'][:] = tokens[:, 1:].astype(np.float32)
    first = None
    for _ in range(steps):
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if k not in ('data', 'softmax_label')}
        if first is None:
            first = (out, grads)
        for name, arr in ex.arg_dict.items():
            g = ex.grad_dict.get(name)
            if g is not None and name not in ('data', 'softmax_label'):
                arr[:] = (arr - lr * g).asnumpy()
    return first, out, ex


@pytest.mark.parametrize('placement', ('split', 'one'))
def test_model_parallel_lstm_against_jax_and_unpartitioned(placement):
    groups = ['embed', 'layer0', 'layer1', 'decode']
    g2c = {g: tmx.cpu(i if placement == 'split' else 0)
           for i, g in enumerate(groups)}
    jg2c = {g: jmx.tpu(i if placement == 'split' else 0)
            for i, g in enumerate(groups)}
    (out, grads), last, ex = _lstm_steps(tmx, TLSTMCell, g2c)
    (jout, jgrads), jlast, _ = _lstm_steps(jmx, JLSTMCell, jg2c)
    (pout, pgrads), plast, _ = _lstm_steps(tmx, TLSTMCell, None)
    for want_out, want_grads in ((jout, jgrads), (pout, pgrads)):
        _close(out, want_out)
        assert sorted(grads) == sorted(want_grads)
        for k in grads:
            _close(grads[k], want_grads[k])
    _close(last, jlast)
    _close(last, plast)
    for name, g in ex.grad_dict.items():
        assert g.context == ex.arg_dict[name].context
