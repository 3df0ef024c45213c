"""Custom operators of the PyTorch port against the JAX package's, on the
CPU (mirrors tests/test_operator_custom.py): imperative, symbolic
forward/backward, in a graph, infer_shape, NumpyOp / NDArrayOp, the
request kinds of CustomOp.assign, JSON round trips, and Module.fit of a
narrow ResNet v2 whose loss head is a Custom softmax (numpy on the JAX
side, nd.* in the port).  Tolerances: exact where the same float32
operations run in the same order (elementwise ops); rtol 1e-5, atol 1e-6
where sums run in another order in the two frameworks."""
from collections import Counter

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import operator as jop
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import operator as top
from mxnet_tpu_torch.models import resnet as tresnet

CONTEXTS = []           # what create_operator received in the port


def _define_sqr(pkg, opmod):
    @opmod.register('sqr_t')
    class SqrProp(opmod.CustomOpProp):
        def __init__(self, scale='1.0'):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ['data']

        def list_outputs(self):
            return ['output']

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            if pkg is tmx:
                CONTEXTS.append(ctx)
            return Sqr(self.scale)

    class Sqr(opmod.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        pkg.nd.square(in_data[0]) * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * in_data[0] * (2.0 * self.scale))


_define_sqr(mx, jop)
_define_sqr(tmx, top)


def _softmax_head(pkg, opmod, name):
    """The loss head of examples/numpy_ops.py: softmax forward, backward
    y - onehot(label), need_top_grad=False.  numpy in the JAX package,
    nd.* in the port."""

    @opmod.register(name)
    class SoftmaxProp(opmod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            if pkg is tmx:
                CONTEXTS.append(ctx)
                return NdSoftmax()
            return NumpySoftmax()

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
            x = in_data[0]
            e = pkg.nd.exp(x - pkg.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / pkg.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            hot = pkg.nd.one_hot(in_data[1], depth=y.shape[1])
            self.assign(in_grad[0], req[0], y - hot)


_softmax_head(mx, jop, 'softmax_head_t')
_softmax_head(tmx, top, 'softmax_head_t')


def test_custom_imperative_matches_jax():
    x = np.array([[1.0, 2.0], [3.0, -4.0]], np.float32)
    got = tmx.nd.Custom(tmx.nd.array(x), op_type='sqr_t', scale=3)
    want = mx.nd.Custom(mx.nd.array(x), op_type='sqr_t', scale=3)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert CONTEXTS[-1] == tmx.cpu(0)


def _bind(pkg, s, x, grad):
    return s.bind(pkg.cpu(), {'data': pkg.nd.array(x)},
                  args_grad={'data': grad})


def test_custom_symbolic_forward_backward_matches_jax():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    og = np.array([[0.5, -1.0], [2.0, 1.0]], np.float32)
    res = {}
    for pkg in (tmx, mx):
        out = pkg.sym.Custom(pkg.sym.Variable('data'), op_type='sqr_t',
                             name='sqr0')
        grad = pkg.nd.zeros((2, 2))
        ex = _bind(pkg, out, x, grad)
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(pkg.nd.array(og))
        res[pkg] = (y, grad.asnumpy())
    for t, j in zip(res[tmx], res[mx]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(res[tmx][1], 2 * x * og)


def test_custom_in_graph_matches_jax():
    """A Custom op composes with regular ops (Symbol * scalar, sum,
    make_loss) and autograd flows through it."""
    x = np.array([1.0, 2.0, -0.5], np.float32)
    grads = {}
    for pkg in (tmx, mx):
        data = pkg.sym.Variable('data')
        net = pkg.sym.Custom(data, op_type='sqr_t', name='sq')
        loss = pkg.sym.make_loss(pkg.sym.sum(net * 3.0))
        grad = pkg.nd.zeros((3,))
        ex = _bind(pkg, loss, x, grad)
        ex.forward(is_train=True)
        ex.backward()
        grads[pkg] = grad.asnumpy()
    np.testing.assert_array_equal(grads[tmx], grads[mx])
    np.testing.assert_array_equal(grads[tmx], 3 * 2 * x)


def test_custom_infer_shape_runs_no_user_code():
    before = len(CONTEXTS)
    for pkg in (tmx, mx):
        out = pkg.sym.Custom(pkg.sym.Variable('data'), op_type='sqr_t')
        _, out_shapes, _ = out.infer_shape(data=(5, 7))
        assert out_shapes == [(5, 7)]
        head = pkg.sym.Custom(pkg.sym.Variable('x'),
                              pkg.sym.Variable('lab'),
                              op_type='softmax_head_t')
        args, outs, _ = head.infer_shape(x=(4, 10))
        assert args == [(4, 10), (4,)] and outs == [(4, 10)]
    assert len(CONTEXTS) == before      # create_operator never called


def test_custom_json_round_trip_keeps_op_type_and_kwargs():
    s = tmx.sym.Custom(tmx.sym.Variable('data'), op_type='sqr_t', scale=2.5,
                       name='c')
    j = mx.sym.Custom(mx.sym.Variable('data'), op_type='sqr_t', scale=2.5,
                      name='c')
    for text in (s.tojson(), j.tojson()):
        node = [n for n in tmx.sym.load_json(text).topo_nodes()
                if n.op == 'Custom'][0]
        assert node.attrs['op_type'] == 'sqr_t'
        assert str(node.attrs['scale']) == '2.5'
    x = np.array([1.0, -2.0], np.float32)
    got = tmx.sym.load_json(s.tojson()).bind(
        tmx.cpu(), {'data': tmx.nd.array(x)}).forward()[0].asnumpy()
    np.testing.assert_array_equal(got, 2.5 * x * x)


@pytest.mark.parametrize('req', ['write', 'inplace', 'add', 'null'])
def test_assign_honours_the_request(req):
    for pkg, opmod in ((tmx, top), (mx, jop)):
        dst = pkg.nd.array([1.0, 2.0])
        opmod.CustomOp().assign(dst, req, pkg.nd.array([10.0, 20.0]))
        want = {'write': [10, 20], 'inplace': [10, 20], 'add': [11, 22],
                'null': [1, 2]}[req]
        np.testing.assert_array_equal(dst.asnumpy(), want)


def test_numpy_op_matches_jax():
    res = {}
    for pkg, opmod in ((tmx, top), (mx, jop)):
        class CubeOp(opmod.NumpyOp):
            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0] ** 3

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = out_grad[0] * 3 * in_data[0] ** 2

        s = CubeOp().get_symbol(pkg.sym.Variable('data'), name='cube')
        x = np.array([1.0, 2.0], np.float32)
        g = pkg.nd.zeros((2,))
        ex = _bind(pkg, s, x, g)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(pkg.nd.array([1.0, 1.0]))
        res[pkg] = (out, g.asnumpy())
    for t, j in zip(res[tmx], res[mx]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(res[tmx][1], [3.0, 12.0])


def test_ndarray_op_matches_jax():
    res = {}
    for pkg, opmod in ((tmx, top), (mx, jop)):
        class Halve(opmod.NDArrayOp):
            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0] * 0.5

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = out_grad[0] * 0.5

        s = Halve().get_symbol(pkg.sym.Variable('data'))
        g = pkg.nd.zeros((3,))
        ex = _bind(pkg, s, np.array([2.0, 4.0, 6.0], np.float32), g)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(pkg.nd.array([1.0, 1.0, 1.0]))
        res[pkg] = (out, g.asnumpy())
    for t, j in zip(res[tmx], res[mx]):
        np.testing.assert_array_equal(t, j)


def test_fuse_passes_treat_custom_as_opaque(monkeypatch):
    """FC -> Custom -> relu: no pass matches across the Custom node (the
    epilogue chain stops at it) in either package; same rewritten graph
    and stats."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    graphs, stats = {}, {}
    for pkg in (tmx, mx):
        with pkg.base.NameManager():
            fc = pkg.sym.FullyConnected(pkg.sym.Variable('data'),
                                        num_hidden=4, name='fc')
            c = pkg.sym.Custom(fc, op_type='sqr_t', name='sq')
            net = pkg.sym.Activation(c, act_type='relu', name='act')
        out = pkg.fuse.apply_fuse_passes(net, True, 'aggressive')
        graphs[pkg] = [(n.op, n.name) for n in out.topo_nodes()]
        stats[pkg] = pkg.fuse.last_run_stats()
    assert graphs[tmx] == graphs[mx]
    assert stats[tmx] == stats[mx]
    assert ('Custom', 'sq') in graphs[tmx]
    assert stats[tmx]['total_rewrites'] == 0


def test_need_top_grad_false_head_gets_its_gradient_in_the_fused_step():
    """parallel.make_fit_step seeds zero head cotangents; the Custom
    softmax head still injects y - onehot(label)."""
    from mxnet_tpu_torch.parallel import train_step as ts
    r = np.random.RandomState(3)
    x = r.randn(4, 6).astype(np.float32)
    w = r.randn(5, 6).astype(np.float32) * 0.3
    lab = np.array([0, 4, 2, 2], np.float32)
    fc = tmx.sym.FullyConnected(tmx.sym.Variable('data'), num_hidden=5,
                                no_bias=True, name='fc')
    net = tmx.sym.Custom(fc, tmx.sym.Variable('softmax_label'),
                         op_type='softmax_head_t', name='softmax')
    params = {'fc_weight': torch.from_numpy(w.copy())}
    step = ts.make_train_step(net, ts.make_sgd_momentum(
        lr=1.0, momentum=0.0, wd=0.0), ('data', 'softmax_label'))
    outs, params, _, _ = step(params, {}, ts.sgd_momentum_init(params), {
        'data': torch.from_numpy(x), 'softmax_label': torch.from_numpy(lab)})
    logits = x @ w.T
    y = np.exp(logits - logits.max(1, keepdims=True))
    y /= y.sum(1, keepdims=True)
    np.testing.assert_allclose(outs[0].numpy(), y, rtol=1e-5, atol=1e-6)
    dy = y.copy()
    dy[np.arange(4), lab.astype(int)] -= 1.0
    np.testing.assert_allclose(params['fc_weight'].numpy(), w - dy.T @ x,
                               rtol=1e-5, atol=1e-6)


def _narrow_resnet_head(pkg, res):
    """A narrow ResNet v2 whose SoftmaxOutput is replaced by a Custom
    softmax over fc1's output, built from each package's own models (with
    fresh auto-name counters, so that both graphs get the same names)."""
    with pkg.base.NameManager():
        net = res.resnet(units=[1, 1, 1, 1], num_stages=4,
                         filter_list=[8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 32, 32))
        fc1 = net.get_internals()['fc1_output']
        return pkg.sym.Custom(fc1, pkg.sym.Variable('softmax_label'),
                              op_type='softmax_head_t', name='softmax')


def test_resnet_fit_with_custom_head_matches_jax(monkeypatch):
    """Three float32 SGD-momentum steps of Module.fit on a narrow ResNet
    v2 with a Custom softmax head, MXTPU_FUSE=aggressive, in both
    packages (the JAX kernels in Pallas interpret mode): the same fused
    graph and pass stats, updated parameters within rtol 1e-5, atol 1e-6,
    and the head's outputs too; create_operator saw cpu(0)."""
    from mxnet_tpu.models import resnet as jresnet
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    batch, steps = 4, 3
    tsym = _narrow_resnet_head(tmx, tresnet)
    jsym = _narrow_resnet_head(mx, jresnet)
    assert [(n.op, n.name) for n in tsym.topo_nodes()] == \
        [(n.op, n.name) for n in jsym.topo_nodes()]
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 32, 32)}, 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((batch * steps, 3, 32, 32), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    opt = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
    mods, stats = {}, {}
    del CONTEXTS[:]
    for pkg, sym in ((tmx, tsym), (mx, jsym)):
        m = pkg.mod.Module(sym, context=pkg.cpu())
        m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
              optimizer='sgd', optimizer_params=opt,
              arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
              aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
        mods[pkg] = m
        stats[pkg] = pkg.fuse.last_run_stats()
    assert stats[tmx] == stats[mx]
    assert stats[tmx]['passes']['bn_relu_conv']['rewrites'] == 16
    assert CONTEXTS and set(CONTEXTS) == {tmx.cpu(0)}
    # the port builds one operator per forward (the JAX package one more
    # per backward)
    assert len(CONTEXTS) == steps
    (ta, tx), (ja, jx) = mods[tmx].get_params(), mods[mx].get_params()
    moved = 0.0
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.max(np.abs(ta[k].asnumpy() - arg[k]))))
    for k in jx:
        np.testing.assert_allclose(tx[k].asnumpy(), jx[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert moved > 1e-3
    outs = [m.predict(pkg.io.NDArrayIter(x[:batch], y[:batch],
                                         batch_size=batch)).asnumpy()
            for pkg, m in ((tmx, mods[tmx]), (mx, mods[mx]))]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0].sum(axis=1), 1.0, rtol=1e-5)
    assert Counter(n.op for n in tsym.topo_nodes())['Custom'] == 1
