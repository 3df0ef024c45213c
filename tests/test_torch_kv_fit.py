"""Data-parallel training through the port's kvstore, against the JAX
package on the CPU:

- a context list, ``Module(context=[cpu(0), cpu(1)])`` with
  ``kvstore='local'`` and ``'device'``: the port's two executors (one per
  context, gradients summed by the store) against the JAX ``Module`` on
  two of its eight CPU devices (one SPMD program), on an MLP and on the
  narrow ResNet v2 (``MXTPU_FUSE=aggressive``, f32), whose BatchNorm
  normalises the whole batch in both: the port's executors share their
  batch statistics.  Parameters and moving statistics agree to rtol 1e-5;
- ``FeedForward(ctx=[cpu(0), cpu(1)]).fit(work_load_list=[1, 3])``
  against the JAX estimator;
- a one-worker ``dist_async`` fit (the server thread in this process,
  ``update_on_kvstore``: the optimizer runs on the server per push) of
  the narrow ResNet v2 against the JAX package's;
- ``BucketingModule`` over a context list with a ``'local'`` store, every
  bucket borrowing it, against the JAX ``BucketingModule``.

The 2-rank ``dist_sync`` fit against a one-process fit at the global
batch is in ``tests/test_torch_dist_kvstore.py`` (it needs worker
processes)."""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet as tresnet

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
RTOL, ATOL = 1e-5, 1e-6


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=12,
                                 name='fc1')
    net = pkg.sym.Activation(net, act_type='relu', name='relu1')
    net = pkg.sym.FullyConnected(net, num_hidden=4, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _mlp_case(rows=24):
    r = np.random.RandomState(3)
    x = r.randn(rows, 6).astype(np.float32)
    y = r.randint(0, 4, rows).astype(np.float32)
    arg = {'fc1_weight': r.randn(12, 6).astype(np.float32) * 0.4,
           'fc1_bias': r.randn(12).astype(np.float32) * 0.1,
           'fc2_weight': r.randn(4, 12).astype(np.float32) * 0.4,
           'fc2_bias': np.zeros(4, np.float32)}
    return x, y, arg


def _narrow_resnet():
    return tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                          filter_list=[8, 16, 32, 64, 128], num_classes=10,
                          image_shape=(3, 64, 64))


def _assert_close(got, want, names):
    for k in names:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _fit(pkg, sym, ctx, x, y, batch, arg, aux=None, **kw):
    m = pkg.mod.Module(sym, context=ctx)
    m.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
          optimizer='sgd', optimizer_params=OPT,
          arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
          aux_params={k: pkg.nd.array(v) for k, v in (aux or {}).items()},
          **kw)
    a, x_ = m.get_params()
    return m, {k: v.asnumpy() for k, v in a.items()}, \
        {k: v.asnumpy() for k, v in x_.items()}


@pytest.mark.parametrize('kvstore', ['local', 'device'])
def test_context_list_mlp_matches_the_jax_group(kvstore):
    x, y, arg = _mlp_case()
    tsym = _mlp(tmx)
    tm, got, _ = _fit(tmx, tsym, [tmx.cpu(0), tmx.cpu(1)], x, y, 8, arg,
                      kvstore=kvstore)
    assert len(tm._exec_group.execs) == 2 and tm._kvstore.type == kvstore
    assert tm._fused is None            # the store's path, not the step
    _, want, _ = _fit(mx, mx.sym.load_json(tsym.tojson()),
                      [mx.cpu(0), mx.cpu(1)], x, y, 8, arg, kvstore=kvstore)
    _assert_close(got, want, arg)
    moved = max(float(np.abs(got[k] - arg[k]).max()) for k in arg)
    assert moved > 1e-3


def test_context_list_equals_one_context_on_an_mlp():
    """Two executors through the store against one executor (the fused
    step) at the same batch: the same full-batch gradient."""
    x, y, arg = _mlp_case()
    _, two, _ = _fit(tmx, _mlp(tmx), [tmx.cpu(0), tmx.cpu(1)], x, y, 8, arg)
    _, one, _ = _fit(tmx, _mlp(tmx), tmx.cpu(), x, y, 8, arg)
    _assert_close(two, one, arg)


def _bn_net(pkg):
    net = pkg.sym.Convolution(pkg.sym.Variable('data'), num_filter=4,
                              kernel=(3, 3), pad=(1, 1), name='c1')
    net = pkg.sym.BatchNorm(net, fix_gamma=False, name='bn1')
    net = pkg.sym.Activation(net, act_type='relu', name='relu1')
    net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=3,
                                 name='fc')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _bound(ctx, rows, work=None):
    m = tmx.mod.Module(_bn_net(tmx), context=ctx, work_load_list=work)
    m.bind([('data', (rows, 2, 5, 5))], [('softmax_label', (rows,))])
    r = np.random.RandomState(8)
    m.init_params(arg_params={
        'c1_weight': tmx.nd.array(r.randn(4, 2, 3, 3).astype(np.float32)),
        'c1_bias': tmx.nd.array(r.randn(4).astype(np.float32)),
        'bn1_gamma': tmx.nd.array(1 + r.rand(4).astype(np.float32)),
        'bn1_beta': tmx.nd.array(r.randn(4).astype(np.float32)),
        'fc_weight': tmx.nd.array(r.randn(3, 100).astype(np.float32)),
        'fc_bias': tmx.nd.zeros((3,))})
    return m


@pytest.mark.parametrize('ncontexts,work', [(2, [1, 1]), (2, [1, 3]),
                                            (3, None)])
def test_context_list_batchnorm_normalises_the_whole_batch(ncontexts, work):
    """One forward_backward over a context list against one executor at
    the whole batch: the same outputs, the executors' gradients summing
    to its gradients, every executor's moving statistics equal to its."""
    rows = 12
    r = np.random.RandomState(9)
    batch = tmx.io.DataBatch(
        [tmx.nd.array(r.randn(rows, 2, 5, 5).astype(np.float32) * 3 + 1)],
        [tmx.nd.array(r.randint(0, 3, rows).astype(np.float32))])
    group = _bound([tmx.cpu(i) for i in range(ncontexts)], rows, work)
    one = _bound(tmx.cpu(), rows)
    for m in (group, one):
        m.forward_backward(batch)
    execs = group._exec_group.execs
    assert len(execs) == ncontexts
    np.testing.assert_allclose(group.get_outputs()[0].asnumpy(),
                               one.get_outputs()[0].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    ref = one._exec_group.execs[0]
    for name, g in ref.grad_dict.items():
        if name in ('data', 'softmax_label'):
            continue
        total = sum(e.grad_dict[name].asnumpy() for e in execs)
        np.testing.assert_allclose(total, g.asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name, v in ref.aux_dict.items():
        for e in execs:
            np.testing.assert_allclose(e.aux_dict[name].asnumpy(),
                                       v.asnumpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_group_batch_stats_refuse_executors_that_part():
    """A member that finishes while another waits at a BatchNorm: the
    waiting one raises instead of normalising by its own slice."""
    import threading
    import torch
    from mxnet_tpu_torch.module.executor_group import _GroupBatchStats
    stats = _GroupBatchStats(2)
    raised = []

    def first():
        stats.wait_turn(0)
        try:
            stats.moments(0, torch.ones(4, 3), (0,))
        except tmx.MXNetError as e:
            raised.append(str(e))

    def second():
        stats.wait_turn(1)
        stats.finish(1)
    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert raised and 'different BatchNorms' in raised[0]


def test_a_context_list_refuses_the_mirror(monkeypatch):
    """The mirror recomputes a forward in backward, where one executor
    would see its own slice only."""
    monkeypatch.setenv('MXNET_BACKWARD_DO_MIRROR', '1')
    m = _bound([tmx.cpu(0), tmx.cpu(1)], 4)
    batch = tmx.io.DataBatch([tmx.nd.zeros((4, 2, 5, 5))],
                             [tmx.nd.zeros((4,))])
    with pytest.raises(tmx.MXNetError, match='context list'):
        m.forward_backward(batch)


def test_context_list_resnet_matches_the_jax_group(monkeypatch):
    """The narrow ResNet v2 over ``[cpu(0), cpu(1)]``, two steps of 4 rows
    (2 + 2), against the JAX ``Module`` over the same two contexts: the
    port's BatchNorm normalises the whole batch across its executors, as
    the JAX group's one program does."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    batch, steps = 4, 2
    tsym = _narrow_resnet()
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    tm, got, got_aux = _fit(tmx, tsym, [tmx.cpu(0), tmx.cpu(1)], x, y,
                            batch, arg, aux)
    assert len(tm._exec_group.execs) == 2 and tm._kvstore.type == 'local'
    assert tmx.fuse.last_run_stats()['passes']['bn_relu_conv'][
        'rewrites'] == 16
    _, want, want_aux = _fit(mx, mx.sym.load_json(tsym.tojson()),
                             [mx.cpu(0), mx.cpu(1)], x, y, batch, arg, aux)
    _assert_close(got, want, arg)
    _assert_close(got_aux, want_aux, aux)


def test_feedforward_work_load_list_matches_jax():
    x, y, arg = _mlp_case(rows=32)
    got = {}
    for pkg in (tmx, mx):
        sym = pkg.sym.load_json(_mlp(tmx).tojson())
        model = pkg.FeedForward(sym, ctx=[pkg.cpu(0), pkg.cpu(1)],
                                num_epoch=1, optimizer='sgd',
                                arg_params={k: pkg.nd.array(v)
                                            for k, v in arg.items()},
                                aux_params={}, **OPT)
        model.fit(pkg.io.NDArrayIter(x, y, batch_size=8),
                  work_load_list=[1, 3])
        got[pkg] = {k: v.asnumpy() for k, v in model.arg_params.items()}
    assert got[tmx].keys() == got[mx].keys()
    _assert_close(got[tmx], got[mx], arg)
    m = tmx.Module(_mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)],
                   work_load_list=[1, 3])
    m.bind([('data', (8, 6))], [('softmax_label', (8,))])
    assert m._exec_group.slices == [slice(0, 2), slice(2, 8)]
    with pytest.raises(tmx.MXNetError, match='work_load_list'):
        tmx.Module(_mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)],
                   work_load_list=[1])


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in ('MXTPU_KV_SERVER_ADDR', 'MXTPU_COORDINATOR',
              'MXTPU_PROCESS_ID', 'MXTPU_NUM_PROCESSES'):
        monkeypatch.setenv(k, 'x')
        monkeypatch.delenv(k)
    yield
    os.environ.pop('MXTPU_KV_SERVER_ADDR', None)


def test_one_worker_dist_async_fit_matches_jax(monkeypatch, no_cluster_env):
    """update_on_kvstore: every push is applied by the server's updater
    (the port's SGD on host tensors, the JAX one on jax arrays), and the
    worker pulls the weights back."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    batch, steps = 4, 2
    tsym = _narrow_resnet()
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    out = {}
    for pkg in (tmx, mx):
        os.environ.pop('MXTPU_KV_SERVER_ADDR', None)
        sym = pkg.sym.load_json(tsym.tojson())
        m, got, got_aux = _fit(pkg, sym, pkg.cpu(), x, y, batch, arg, aux,
                               kvstore='dist_async')
        kv = m._kvstore
        try:
            assert kv.type == 'dist_async' and m._update_on_kvstore
            assert kv._server.applied_pushes == steps * len(arg)
        finally:
            kv.close()
        out[pkg] = (got, got_aux)
    assert out[tmx][0].keys() == out[mx][0].keys()
    _assert_close(out[tmx][0], out[mx][0], arg)
    _assert_close(out[tmx][1], out[mx][1], aux)


def _fc_gen(pkg):
    """A bucketed graph whose every bucket shares one (3, 1) weight."""
    def sym_gen(key):
        data = pkg.sym.Variable('data')
        flat = pkg.sym.Reshape(data, shape=(-1, 1), name='flat')
        fc = pkg.sym.FullyConnected(flat, num_hidden=3, name='fc')
        label = pkg.sym.Reshape(pkg.sym.Variable('softmax_label'),
                                shape=(-1,), name='flat_label')
        return (pkg.sym.SoftmaxOutput(fc, label, name='softmax'),
                ('data',), ('softmax_label',))
    return sym_gen


def test_bucketing_module_over_a_context_list_shares_the_store():
    """BucketingModule(context=[cpu(0), cpu(1)]) with kvstore='local':
    every bucket borrows the default bucket's store, its executors share
    the default's arrays context by context, and alternating buckets
    train what the JAX BucketingModule on one context trains."""
    r = np.random.RandomState(6)
    weight = r.randn(3, 1).astype(np.float32)
    got = {}
    for pkg, ctx in ((tmx, [tmx.cpu(0), tmx.cpu(1)]), (mx, mx.cpu())):
        mod = pkg.mod.BucketingModule(_fc_gen(pkg), default_bucket_key=6,
                                      context=ctx)
        mod.bind([('data', (4, 6))], [('softmax_label', (4, 6))])
        mod.init_params(arg_params={'fc_weight': pkg.nd.array(weight),
                                    'fc_bias': pkg.nd.zeros((3,))})
        mod.init_optimizer(kvstore='local', optimizer_params=OPT)
        for step, key in enumerate((6, 4, 6, 4)):
            rs = np.random.RandomState(step)
            batch = pkg.io.DataBatch(
                [pkg.nd.array(rs.randn(4, key).astype(np.float32))],
                [pkg.nd.array(rs.randint(0, 3, (4, key)).astype(
                    np.float32))], bucket_key=key,
                provide_data=[('data', (4, key))],
                provide_label=[('softmax_label', (4, key))])
            mod.forward_backward(batch)
            mod.update()
        if pkg is tmx:
            default = mod._buckets[6]
            assert default._kvstore is not None
            assert all(m._kvstore is default._kvstore
                       for m in mod._buckets.values())
            assert len(mod._buckets[4]._exec_group.execs) == 2
            for e, d in zip(mod._buckets[4]._exec_group.execs,
                            default._exec_group.execs):
                assert e.arg_dict['fc_weight'] is d.arg_dict['fc_weight']
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _assert_close(got[tmx], got[mx], ['fc_weight', 'fc_bias'])
