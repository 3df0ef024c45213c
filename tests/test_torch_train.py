"""The training slice of the PyTorch port against the JAX package on the
CPU: the optimizer (functional and Updater forms, lr schedulers), the
data iterator, metrics, initializers, Executor backward with every
grad_req, and N-step parameter parity of ``Module.fit`` under
``MXTPU_FUSE=aggressive``.

Both packages get the same numpy inputs and initial parameters (their
RNGs differ).  Tolerances: rtol 1e-4, atol 1e-5 for trained parameters
(tests/test_fuse_bn_conv.py:133-135: float32 sums run in another order in
the two frameworks and compound over the steps); rtol 1e-6 for the
optimizer alone (the same arithmetic on the same inputs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet as tresnet

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_case(seed=0):
    r = np.random.RandomState(seed)
    names = ['fc_weight', 'fc_bias', 'bn_gamma']
    params = {n: r.randn(5, 3).astype(np.float32) for n in names}
    grads = [{n: r.randn(5, 3).astype(np.float32) * 4 for n in names}
             for _ in range(4)]
    return names, params, grads


@pytest.mark.parametrize('momentum', [0.0, 0.9])
@pytest.mark.parametrize('sched', [None, 'factor'])
def test_sgd_functional_update_matches_jax(momentum, sched):
    """make_functional's update (the fused step's optimizer), four steps,
    rescale_grad, clip_gradient, the bias's zero wd multiplier and a
    FactorScheduler driving the host lr."""
    names, params, grads = _opt_case()
    kw = dict(learning_rate=0.1, momentum=momentum, wd=0.01,
              rescale_grad=0.5, clip_gradient=1.5,
              param_idx2name=dict(enumerate(names)))
    jopt = mx.optimizer.create('sgd', lr_scheduler=mx.lr_scheduler
                               .FactorScheduler(2, 0.5) if sched else None,
                               **kw)
    topt = tmx.optimizer.create('sgd', lr_scheduler=tmx.lr_scheduler
                                .FactorScheduler(2, 0.5) if sched else None,
                                **kw)
    idx = {n: i for i, n in enumerate(names)}
    jf, tf_ = jopt.make_functional(names, idx), topt.make_functional(names,
                                                                     idx)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    js, ts = jf.init(jp), tf_.init(tp)
    for g in grads:
        for o in (jopt, topt):
            for i in range(len(names)):
                o._update_count(i)
        assert jopt.host_lr() == topt.host_lr()
        jp, js = jf.update(jp, {n: jnp.asarray(v) for n, v in g.items()},
                           js, jnp.float32(jopt.host_lr()))
        tf_.update(tp, {n: torch.from_numpy(v) for n, v in g.items()}, ts,
                   topt.host_lr())
    for n in names:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_make_sgd_momentum_matches_jax():
    """parallel/train_step.py's bare SGD-momentum update (in place in
    the port) against the JAX one, three steps."""
    from mxnet_tpu.parallel import train_step as jts
    from mxnet_tpu_torch.parallel import train_step as tts
    names, params, grads = _opt_case(2)
    kw = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=0.25)
    jupd, tupd = jts.make_sgd_momentum(**kw), tts.make_sgd_momentum(**kw)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    js, ts = jts.sgd_momentum_init(jp), tts.sgd_momentum_init(tp)
    for g in grads[:3]:
        jp, js = jupd(jp, {n: jnp.asarray(v) for n, v in g.items()}, js)
        tupd(tp, {n: torch.from_numpy(v) for n, v in g.items()}, ts)
    for n in names:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_sgd_updater_matches_jax():
    """The per-parameter Updater loop (Module.update's path)."""
    names, params, grads = _opt_case(1)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01, rescale_grad=0.25,
              param_idx2name=dict(enumerate(names)))
    jupd = mx.optimizer.get_updater(mx.optimizer.create('sgd', **kw))
    tupd = tmx.optimizer.get_updater(tmx.optimizer.create('sgd', **kw))
    jw = {n: mx.nd.array(v) for n, v in params.items()}
    tw = {n: tmx.nd.array(v) for n, v in params.items()}
    for g in grads:
        for i, n in enumerate(names):
            jupd(i, mx.nd.array(g[n]), jw[n])
            tupd(i, tmx.nd.array(g[n]), tw[n])
    for n in names:
        np.testing.assert_allclose(tw[n].asnumpy(), jw[n].asnumpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize('kind', ['factor', 'multifactor'])
def test_lr_schedulers_match_jax(kind):
    def make(pkg):
        if kind == 'factor':
            s = pkg.lr_scheduler.FactorScheduler(3, 0.5, stop_factor_lr=0.01)
        else:
            s = pkg.lr_scheduler.MultiFactorScheduler([2, 5, 9], 0.3)
        s.base_lr = 0.2
        return s
    js, ts = make(mx), make(tmx)
    assert [ts(n) for n in range(20)] == [js(n) for n in range(20)]


# ---------------------------------------------------------------------------
# data iterator, metrics, initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('last', ['pad', 'discard', 'roll_over'])
def test_ndarrayiter_matches_jax(last):
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    y = np.arange(7, dtype=np.float32)
    jit = mx.io.NDArrayIter(x, y, batch_size=3, last_batch_handle=last)
    tit = tmx.io.NDArrayIter(x, y, batch_size=3, last_batch_handle=last)
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label
    for _ in range(2):          # two epochs: roll_over carries the tail
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
        jit.reset()
        tit.reset()


@pytest.mark.parametrize('name,kw', [('acc', {}), ('ce', {}),
                                     ('top_k_accuracy', {'top_k': 3})])
def test_metrics_match_jax_both_paths(name, kw):
    """The host path against the JAX metric, and the device path (the
    fused step's fold) against the host path."""
    r = np.random.RandomState(2)
    preds = [r.dirichlet(np.ones(6), size=5).astype(np.float32)
             for _ in range(3)]
    labels = [r.randint(0, 6, 5).astype(np.float32) for _ in range(3)]
    jm, tm, dm = (mx.metric.create(name, **kw), tmx.metric.create(name, **kw),
                  tmx.metric.create(name, **kw))
    for p, lab in zip(preds, labels):
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        tm.update([tmx.nd.array(lab)], [tmx.nd.array(p)])
        dm.device_fold(torch.from_numpy(lab), torch.from_numpy(p))
    before = tmx.instrument.counter_value('metric.host_syncs')
    (jn, jv), (tn, tv), (dn, dv) = jm.get(), tm.get(), dm.get()
    assert tn == jn == dn
    assert tmx.instrument.counter_value('metric.host_syncs') == before + 1
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_allclose(dv, tv, rtol=1e-6)


def test_composite_metric_drains_once():
    m = tmx.metric.create(['acc', 'ce'])
    p = torch.tensor([[0.2, 0.8], [0.6, 0.4]])
    m.device_fold(torch.tensor([1.0, 1.0]), p)
    before = tmx.instrument.counter_value('metric.host_syncs')
    names, values = m.get()
    assert names == ['accuracy', 'cross-entropy']
    assert values[0] == 0.5
    assert tmx.instrument.counter_value('metric.host_syncs') == before + 1


def test_initializers_route_by_name():
    tmx.random.seed(3)
    arrs = {n: tmx.nd.zeros((40, 30)) for n in
            ('fc_weight', 'fc_bias', 'bn_gamma', 'bn_beta', 'bn_moving_var',
             'bn_moving_mean')}
    init = tmx.init.Xavier(factor_type='in', magnitude=2.0)
    for n, a in arrs.items():
        init(tmx.init.InitDesc(n), a)
    w = arrs['fc_weight'].asnumpy()
    bound = np.sqrt(2.0 / 30)
    assert np.all(np.abs(w) <= bound) and w.std() > bound / 3
    assert np.all(arrs['fc_bias'].asnumpy() == 0)
    assert np.all(arrs['bn_gamma'].asnumpy() == 1)
    assert np.all(arrs['bn_moving_var'].asnumpy() == 1)
    assert np.all(arrs['bn_moving_mean'].asnumpy() == 0)
    # same seed, same draws; Mixed and Load dispatch
    a, b = tmx.nd.zeros((4, 4)), tmx.nd.zeros((4, 4))
    tmx.random.seed(7)
    tmx.init.Normal(0.5)('w_weight', a)
    tmx.random.seed(7)
    tmx.init.Mixed(['.*bias', '.*'], [tmx.init.Zero(),
                                      tmx.init.Normal(0.5)])('w_weight', b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    c = tmx.nd.zeros((4, 4))
    tmx.init.Load({'arg:w_weight': a})('w_weight', c)
    np.testing.assert_array_equal(c.asnumpy(), a.asnumpy())
    with pytest.raises(ValueError):
        tmx.init.Load({})('x_weight', c)


# ---------------------------------------------------------------------------
# executor backward
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu', name='relu1')
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name='fc2')
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


@pytest.mark.parametrize('grad_req', ['write', 'add', 'null'])
def test_executor_backward_matches_jax(grad_req, monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    r = np.random.RandomState(4)
    vals = {'data': r.randn(6, 5).astype(np.float32),
            'fc1_weight': r.randn(8, 5).astype(np.float32) * 0.5,
            'fc1_bias': r.randn(8).astype(np.float32) * 0.1,
            'fc2_weight': r.randn(4, 8).astype(np.float32) * 0.5,
            'fc2_bias': r.randn(4).astype(np.float32) * 0.1,
            'softmax_label': r.randint(0, 4, 6).astype(np.float32)}
    req = {n: (grad_req if n.startswith('fc') else 'null') for n in vals}
    res = {}
    for pkg in (tmx, mx):
        exe = _mlp(pkg).simple_bind(pkg.cpu(), grad_req=req, data=(6, 5))
        for k, v in vals.items():
            exe.arg_dict[k][:] = v
        for _ in range(2):      # 'add' accumulates over the two passes
            exe.forward(is_train=True)
            exe.backward()
        res[pkg] = ({k: v.asnumpy() for k, v in exe.grad_dict.items()},
                    exe.outputs[0].asnumpy())
    tg, tout = res[tmx]
    jg, jout = res[mx]
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if grad_req == 'null':
        assert not tg


def test_backward_needs_a_training_forward():
    exe = _mlp(tmx).simple_bind(tmx.cpu(), data=(2, 5))
    with pytest.raises(tmx.MXNetError, match='forward'):
        exe.backward()


# ---------------------------------------------------------------------------
# Module.fit parity
# ---------------------------------------------------------------------------

def _narrow_resnet(res):
    return res.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[8, 16, 32, 64, 128], num_classes=10,
                      image_shape=(3, 64, 64))


def _fit_both(tsym, arg, aux, x, y, batch, compute_dtype=None, **fit_kw):
    tm = tmx.Module(tsym, context=tmx.cpu(), compute_dtype=compute_dtype)
    tm.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
           optimizer='sgd', optimizer_params=OPT,
           arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
           aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
           **fit_kw)
    jm = mx.mod.Module(mx.sym.load_json(tsym.tojson()), context=mx.cpu())
    jm.fit(mx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
           optimizer='sgd', optimizer_params=OPT,
           arg_params={k: mx.nd.array(v) for k, v in arg.items()},
           aux_params={k: mx.nd.array(v) for k, v in aux.items()}, **fit_kw)
    return tm, jm


def _assert_params_match(tm, jm, arg):
    (ta, tx), (ja, jx) = tm.get_params(), jm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    moved = 0.0
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        moved = max(moved, float(np.max(np.abs(ta[k].asnumpy() - arg[k]))))
    for k in jx:
        np.testing.assert_allclose(tx[k].asnumpy(), jx[k].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert moved > 1e-3


def test_resnet_fit_matches_jax(monkeypatch):
    """Three SGD-momentum steps of a narrow ResNet v2 (ImageNet stem,
    3x64x64, 10 classes) through Module.fit under MXTPU_FUSE=aggressive
    in both packages: the port's fused step over 16 _bn_relu_conv nodes
    against the JAX fused step over the same graph (Pallas interpreter).

    Parity across a relu kink needs every pre-activation to stay clear of
    float32 noise: with these inputs the closest is far from zero (some
    seeds put one within 1e-5 of zero at step 3, and the two frameworks'
    1e-6 differences then flip its mask)."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    batch, steps = 4, 3
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    before = tmx.instrument.counter_value('module.fused_steps')
    tm, jm = _fit_both(tsym, arg, aux, x, y, batch)
    assert tmx.instrument.counter_value('module.fused_steps') == \
        before + steps
    assert tmx.fuse.last_run_stats()['passes']['bn_relu_conv'][
        'rewrites'] == 16
    _assert_params_match(tm, jm, arg)


def test_mlp_fit_and_score_match_jax(monkeypatch):
    """An MLP (no fused kernels) through the fused step, then score and
    predict on the trained module, against the JAX package."""
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    r = np.random.RandomState(5)
    x = r.randn(20, 5).astype(np.float32)
    y = r.randint(0, 4, 20).astype(np.float32)
    tsym = _mlp(tmx)
    arg = {'fc1_weight': r.randn(8, 5).astype(np.float32) * 0.5,
           'fc1_bias': np.zeros(8, np.float32),
           'fc2_weight': r.randn(4, 8).astype(np.float32) * 0.5,
           'fc2_bias': np.zeros(4, np.float32)}
    tm, jm = _fit_both(tsym, arg, {}, x, y, 6)    # 4 batches, last padded
    _assert_params_match(tm, jm, arg)
    it = [pkg.io.NDArrayIter(x, y, batch_size=6) for pkg in (tmx, mx)]
    ts, js = tm.score(it[0], 'acc'), jm.score(it[1], 'acc')
    assert ts == js
    tp, jp = tm.predict(it[0]), jm.predict(it[1])
    assert tp.shape == jp.shape == (20, 4)
    np.testing.assert_allclose(tp.asnumpy(), jp.asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_updater_path_matches_fused_step(monkeypatch):
    """Module.fit's fused step and the forward_backward + update loop it
    replaces train the same parameters."""
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    r = np.random.RandomState(6)
    x = r.randn(12, 5).astype(np.float32)
    y = r.randint(0, 4, 12).astype(np.float32)
    arg = {'fc1_weight': r.randn(8, 5).astype(np.float32) * 0.5,
           'fc1_bias': np.zeros(8, np.float32),
           'fc2_weight': r.randn(4, 8).astype(np.float32) * 0.5,
           'fc2_bias': np.zeros(4, np.float32)}
    fused = tmx.Module(_mlp(tmx), context=tmx.cpu())
    fused.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
              optimizer_params=OPT,
              arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
    loop = tmx.Module(_mlp(tmx), context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=4)
    loop.bind(it.provide_data, it.provide_label)
    loop.init_params(arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
    loop.init_optimizer(optimizer_params=OPT)
    for _ in range(2):
        for b in it:
            loop.forward_backward(b)
            loop.update()
        it.reset()
    for k in arg:
        np.testing.assert_allclose(fused.get_params()[0][k].asnumpy(),
                                   loop.get_params()[0][k].asnumpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_bf16_compute_keeps_f32_masters(monkeypatch):
    """compute_dtype=bfloat16: the forward/backward run in bf16 through
    the fused kernels' plain versions and the master weights stay
    float32.  bf16 rounds every activation and gradient, so the update
    is compared by direction: over all parameters, the port's bf16 update
    against its float32 one and against the JAX package's bf16 one
    (Module(compute_dtype=jnp.bfloat16)).  On this net and data both
    packages' bf16 runs sit at a cosine of about 0.93 from float32, and
    from each other; the bound is 0.85."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    tsym = _narrow_resnet(tresnet)
    arg, aux = convert.random_params(tsym, {'data': (4, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, 8).astype(np.float32)
    delta = {}
    for pkg, dt in ((tmx, None), (tmx, torch.bfloat16), (mx, jnp.bfloat16)):
        ctx = pkg.cpu()
        m = pkg.mod.Module(pkg.sym.load_json(tsym.tojson()), context=ctx,
                           compute_dtype=dt)
        m.fit(pkg.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
              optimizer='sgd', optimizer_params=OPT,
              arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
              aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
        params = m.get_params()[0]
        if pkg is tmx:
            assert all(params[k].dtype == torch.float32 for k in arg)
        delta[pkg, dt] = np.concatenate(
            [(params[k].asnumpy() - arg[k]).ravel() for k in sorted(arg)])

    def cos(a, b):
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    t16 = delta[tmx, torch.bfloat16]
    assert np.all(np.isfinite(t16)) and np.max(np.abs(t16)) > 1e-3
    assert cos(t16, delta[tmx, None]) > 0.85
    assert cos(t16, delta[mx, jnp.bfloat16]) > 0.85


def test_fit_refuses_unported_options():
    """A mesh needs one process per position: '2x1' in a one-process job
    raises (tests/test_torch_mesh.py runs meshes on gloo ranks), as the
    JAX package's does over too few devices; ``partition`` without a mesh
    trains the unmeshed fit, as in the reference."""
    m = tmx.Module(_mlp(tmx), context=tmx.cpu())
    it = tmx.io.NDArrayIter(np.zeros((4, 5), np.float32),
                            np.zeros(4, np.float32), batch_size=2)
    with pytest.raises(ValueError, match='needs 2 ranks'):
        m.fit(it, num_epoch=1, mesh='2x1')
    m.fit(it, num_epoch=1, partition='auto')
    assert m._mesh_plan is None and m._fused is not None
