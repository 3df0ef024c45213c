"""The port's optimizers against the JAX package's on the CPU: the update
ops of ``ops/optim.py`` (``nd.<op>(..., out=[...])``, written in place),
every optimizer's imperative ``update`` and functional ``update_one``
over five steps, SGLD by the statistics of its noise, the fused fit step
against the ``Updater`` loop (``MXTPU_FUSED_FIT``) and against the JAX
fused fit, and ``Updater.get_states``/``set_states`` within the port and
across the two packages.

The same numpy inputs go to both packages.  Tolerances: the functional
forms run the reference's arithmetic in the same order and are held to
rtol 1e-6; the imperative forms to rtol 1e-5 (the reference jit-compiles
each op, and XLA may contract a multiply-add); fits to 2e-5, the
reference's own bound (tests/test_module_fused.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

NAMES = ['fc_weight', 'fc_bias', 'bn_gamma']

CASES = [
    ('sgd', {}),
    ('sgd', {'momentum': 0.9, 'wd': 1e-3, 'clip_gradient': 0.5}),
    ('nag', {'momentum': 0.9, 'wd': 1e-3}),
    ('adam', {'wd': 1e-4}),
    ('adagrad', {'wd': 1e-3}),
    ('rmsprop', {'wd': 1e-4}),
    ('rmsprop', {'centered': True, 'clip_weights': 1.5}),
    ('dcasgd', {'momentum': 0.9, 'wd': 1e-3}),
    ('adadelta', {'wd': 1e-3}),
    ('ccsgd', {'momentum': 0.9}),
    ('test', {}),
]
IMPERATIVE_ONLY = ('dcasgd', 'adadelta', 'sgld', 'test')


def _case_id(case):
    name, kw = case
    return name + ''.join('-%s' % k for k in sorted(kw))


def _steps(seed=0, n=5):
    r = np.random.RandomState(seed)
    params = {k: r.randn(5, 3).astype(np.float32) for k in NAMES}
    grads = [{k: r.randn(5, 3).astype(np.float32) * 2 for k in NAMES}
             for _ in range(n)]
    return params, grads


def _opt(pkg, name, kw):
    return pkg.optimizer.create(name, learning_rate=0.1, rescale_grad=0.5,
                                param_idx2name=dict(enumerate(NAMES)), **kw)


# ---------------------------------------------------------------------------
# update ops
# ---------------------------------------------------------------------------

OPS = [
    ('sgd_update', 0, {'lr': 0.1, 'wd': 1e-3, 'rescale_grad': 0.5}),
    ('sgd_update', 0, {'lr': 0.1, 'clip_gradient': 0.3}),
    ('sgd_mom_update', 1, {'lr': 0.1, 'momentum': 0.9, 'wd': 1e-3}),
    ('sgd_mom_update', 1, {'lr': 0.1, 'momentum': 0.9,
                           'clip_gradient': -1.0}),
    ('adam_update', 2, {'lr': 0.01, 'beta1': 0.8, 'beta2': 0.99,
                        'wd': 1e-4, 'clip_gradient': 1.0}),
    ('rmsprop_update', 1, {'lr': 0.01, 'gamma1': 0.8, 'wd': 1e-4,
                           'clip_weights': 1.2}),
    ('rmspropalex_update', 3, {'lr': 0.01, 'gamma1': 0.9, 'gamma2': 0.8,
                               'rescale_grad': 0.5}),
]


@pytest.mark.parametrize('op,nstate,attrs', OPS,
                         ids=['%s-%d' % (o[0], i) for i, o in enumerate(OPS)])
def test_update_op_matches_jax(op, nstate, attrs):
    """``nd.<op>(w, g, *states, out=[w, *states])`` over five steps: the
    same values as the JAX op, written into the out arrays' own
    tensors."""
    params, grads = _steps(1)
    w0 = params['fc_weight']
    state0 = [np.abs(params['bn_gamma']) * (i + 1) * 0.1
              for i in range(nstate)]
    arrays = {}
    for pkg in (mx, tmx):
        w = pkg.nd.array(w0)
        states = [pkg.nd.array(s) for s in state0]
        tensors = [a.handle for a in [w] + states] if pkg is tmx else None
        for g in grads:
            res = getattr(pkg.nd, op)(w, pkg.nd.array(g['fc_weight']),
                                      *states, out=[w] + states, **attrs)
            assert res[0] is w
        if pkg is tmx:
            assert all(a.handle is t for a, t in zip([w] + states, tensors))
        arrays[pkg] = [a.asnumpy() for a in [w] + states]
    for got, want in zip(arrays[tmx], arrays[mx]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_update_op_through_imperative_invoke_and_a_symbol():
    """The ops register like any other: ``imperative_invoke`` and a
    symbol built from them give the same numbers."""
    r = np.random.RandomState(3)
    w, g, m = (r.randn(4, 2).astype(np.float32) for _ in range(3))
    nw, nm = tmx.nd.imperative_invoke(
        'sgd_mom_update', tmx.nd.array(w), tmx.nd.array(g), tmx.nd.array(m),
        lr=0.1, momentum=0.9)
    sym = tmx.sym.sgd_mom_update(tmx.sym.Variable('w'), tmx.sym.Variable('g'),
                                 tmx.sym.Variable('m'), lr=0.1, momentum=0.9)
    exe = sym.bind(tmx.cpu(), {'w': tmx.nd.array(w), 'g': tmx.nd.array(g),
                               'm': tmx.nd.array(m)})
    outs = exe.forward()
    np.testing.assert_array_equal(outs[0].asnumpy(), nw.asnumpy())
    np.testing.assert_array_equal(outs[1].asnumpy(), nm.asnumpy())
    np.testing.assert_allclose(nm.asnumpy(), 0.9 * m - 0.1 * g, rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers: imperative update and functional update_one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', CASES, ids=[_case_id(c) for c in CASES])
def test_optimizer_matches_jax(case):
    """Five steps of the Updater (``update``) and of the functional form
    (``make_functional``; the lr a 0-dim tensor as the fused step gives
    it) with rescale_grad and the bias's and beta's zero wd multiplier.

    The port's functional form equals its Updater bit for bit: the fused
    step and the loop compute the same numbers.  Both are held to the JAX
    package's Updater (rtol 1e-5), and the functional form to the JAX
    functional form (rtol 1e-6) wherever the two JAX forms agree: Adam's
    and RMSProp's JAX functional form computes 1 - beta in float64, its
    update ops (and MXNet's) in float32, a 1.3e-5 difference in the
    second moment that the port does not copy (ROADMAP Queue 3)."""
    name, kw = case
    params, grads = _steps()
    upd = {pkg: pkg.optimizer.get_updater(_opt(pkg, name, kw))
           for pkg in (mx, tmx)}
    w = {pkg: {k: pkg.nd.array(v) for k, v in params.items()}
         for pkg in (mx, tmx)}
    for g in grads:
        for pkg in (mx, tmx):
            for i, k in enumerate(NAMES):
                upd[pkg](i, pkg.nd.array(g[k]), w[pkg][k])
    for k in NAMES:
        np.testing.assert_allclose(w[tmx][k].asnumpy(), w[mx][k].asnumpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)

    jopt, topt = _opt(mx, name, kw), _opt(tmx, name, kw)
    idx = {k: i for i, k in enumerate(NAMES)}
    jf, tf = jopt.make_functional(NAMES, idx), topt.make_functional(NAMES,
                                                                    idx)
    if name in IMPERATIVE_ONLY:
        assert jf is None and tf is None
        return
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jf.init(jp), tf.init(tp)
    lr_t = torch.zeros(())
    for g in grads:
        for o in (jopt, topt):
            for i in range(len(NAMES)):
                o._update_count(i)
        assert jopt.host_lr() == topt.host_lr()
        lr_t.fill_(topt.host_lr())
        jp, js = jf.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           js, jnp.float32(jopt.host_lr()))
        tf.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                  lr_t)
    for i, k in enumerate(NAMES):
        np.testing.assert_array_equal(tp[k].numpy(), w[tmx][k].asnumpy(),
                                      err_msg=k)
        tleaves = ts[k] if isinstance(ts[k], tuple) else (ts[k],)
        uleaves = upd[tmx].states[i]
        uleaves = uleaves if isinstance(uleaves, tuple) else (uleaves,)
        for a, b in zip(tleaves, uleaves):
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), b.asnumpy(),
                                              err_msg=k)
        if name in ('adam', 'rmsprop'):
            continue
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        jleaves = js[k] if isinstance(js[k], tuple) else (js[k],)
        for a, b in zip(tleaves, jleaves):
            if b is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7, err_msg=k)


def test_reference_forms_differ_in_one_minus_beta():
    """What the port does not copy: the JAX package's functional Adam
    computes 1 - beta2 in float64 (0.0010000000475 once rounded), its
    adam_update op in float32 (0.00099998712), so its two forms' second
    moments differ by 1.3e-5 after one step; the port's two forms
    agree."""
    g = np.full((4,), 3.0, np.float32)
    jopt = mx.optimizer.create('adam', learning_rate=0.1)
    jf = jopt.make_functional(['w'], {'w': 0})
    js = jf.init({'w': jnp.zeros(4)})
    jopt._update_count(0)
    _, js = jf.update({'w': jnp.zeros(4)}, {'w': jnp.asarray(g)}, js,
                      jnp.float32(jopt.host_lr()))
    jupd = mx.optimizer.get_updater(mx.optimizer.create('adam',
                                                        learning_rate=0.1))
    jupd(0, mx.nd.array(g), mx.nd.zeros((4,)))
    fv, iv = float(np.asarray(js['w'][1])[0]), \
        float(jupd.states[0][1].asnumpy()[0])
    assert abs(fv - iv) / iv == pytest.approx(1.29e-5, rel=0.05)
    tupd = tmx.optimizer.get_updater(tmx.optimizer.create('adam',
                                                          learning_rate=0.1))
    tupd(0, tmx.nd.array(g), tmx.nd.zeros((4,)))
    assert float(tupd.states[0][1].asnumpy()[0]) == iv


def test_sgld_noise_statistics():
    """SGLD adds N(0, lr) noise from each framework's own generator: held
    by its mean and variance over 200k draws, in both packages, around a
    known drift."""
    n, lr = 200000, 0.04
    w0 = np.ones((n,), np.float32)
    g = np.full((n,), 2.0, np.float32)
    moved = {}
    for pkg in (mx, tmx):
        pkg.random.seed(7)
        opt = pkg.optimizer.create('sgld', learning_rate=lr)
        w = pkg.nd.array(w0)
        with pkg.cpu():
            pkg.optimizer.get_updater(opt)(0, pkg.nd.array(g), w)
        moved[pkg] = w.asnumpy() - w0
    for pkg, d in moved.items():
        noise = d + lr / 2 * 2.0
        assert abs(noise.mean()) < 4 * np.sqrt(lr / n), pkg.__name__
        assert abs(noise.std() / np.sqrt(lr) - 1) < 0.01, pkg.__name__
    assert abs(moved[tmx].std() - moved[mx].std()) < 0.01 * np.sqrt(lr)


def test_optimizer_registry_names():
    assert set(tmx.optimizer.Optimizer.opt_registry) == \
        set(mx.optimizer.Optimizer.opt_registry)


def test_adam_bias_correction_lives_in_host_lr():
    """The fused Adam never reads t: the host lr carries
    sqrt(1 - beta2^t) / (1 - beta1^t), the same number as the JAX
    package's."""
    for t in (1, 2, 10):
        jo, to = (pkg.optimizer.create('adam', learning_rate=0.01,
                                       begin_num_update=t)
                  for pkg in (mx, tmx))
        assert to.host_lr() == jo.host_lr()
        assert to.host_lr() == pytest.approx(
            0.01 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t), rel=1e-12)


# ---------------------------------------------------------------------------
# fused fit step against the Updater loop, and against the JAX fit
# ---------------------------------------------------------------------------

def _mlp(pkg, nclass=4):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=32, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu')
    fc2 = pkg.sym.FullyConnected(act, num_hidden=nclass, name='fc2')
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _synth(n=128, d=16, nclass=4, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, nclass)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    init = {'fc1_weight': rng.uniform(-0.1, 0.1, (32, d)),
            'fc1_bias': np.zeros(32), 'fc2_weight':
            rng.uniform(-0.1, 0.1, (nclass, 32)), 'fc2_bias':
            np.zeros(nclass)}
    return x, y, {k: v.astype(np.float32) for k, v in init.items()}


def _fit(pkg, fused, opt, opt_params, monkeypatch, num_epoch=3):
    x, y, init = _synth()
    monkeypatch.setenv('MXTPU_FUSED_FIT', '1' if fused else '0')
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=32), num_epoch=num_epoch,
            optimizer=opt, optimizer_params=dict(opt_params),
            arg_params={k: pkg.nd.array(v) for k, v in init.items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod


FIT_CASES = [
    ('sgd', {'learning_rate': 0.1}),
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3,
             'clip_gradient': 0.5}),
    ('nag', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}),
    ('adam', {'learning_rate': 0.01, 'wd': 1e-4}),
    ('rmsprop', {'learning_rate': 0.01}),
    ('rmsprop', {'learning_rate': 0.01, 'centered': True}),
    ('adagrad', {'learning_rate': 0.1}),
]


@pytest.mark.parametrize('opt,opt_params', FIT_CASES,
                         ids=[_case_id(c) for c in FIT_CASES])
def test_fused_fit_matches_loop_and_jax(opt, opt_params, monkeypatch):
    """The port's fused fit against its Updater loop (MXTPU_FUSED_FIT=0,
    the update ops) and against the JAX package's fused fit, three
    epochs of an MLP from the same parameters."""
    fused, fmod = _fit(tmx, True, opt, opt_params, monkeypatch)
    loop, lmod = _fit(tmx, False, opt, opt_params, monkeypatch)
    jfused, jmod = _fit(mx, True, opt, opt_params, monkeypatch)
    assert fmod._fused is not None and lmod._fused is None
    assert jmod._fused is not None
    assert lmod._updater.states and not fmod._updater.states
    for k in fused:
        np.testing.assert_allclose(fused[k], loop[k], rtol=2e-5, atol=2e-5,
                                   err_msg=k)
        np.testing.assert_allclose(fused[k], jfused[k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)


def test_imperative_only_optimizer_trains_through_the_loop(monkeypatch):
    """DCASGD has no functional form: Module trains through the Updater
    loop, as the JAX package does, to the same parameters."""
    got = {pkg: _fit(pkg, True, 'dcasgd', {'learning_rate': 0.1,
                                           'momentum': 0.9}, monkeypatch,
                     num_epoch=2) for pkg in (mx, tmx)}
    assert got[tmx][1]._fused is None
    for k in got[mx][0]:
        np.testing.assert_allclose(got[tmx][0][k], got[mx][0][k],
                                   rtol=2e-5, atol=2e-5, err_msg=k)


def test_new_optimizer_drops_the_step_and_its_state(monkeypatch):
    """init_optimizer(force_init=True) with another optimizer forgets the
    fused step, its graphs and its state; the next fit builds Adam's."""
    _, mod = _fit(tmx, True, 'sgd', {'learning_rate': 0.1,
                                     'momentum': 0.9}, monkeypatch, 1)
    assert mod._graphs and mod._fused_opt_state is not None
    mod.init_optimizer(optimizer='adam', force_init=True)
    assert mod._graphs == {} and mod._fused is None and \
        mod._fused_opt_state is None
    x, y, _ = _synth()
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=32), num_epoch=1,
            optimizer='adam')
    assert isinstance(mod._optimizer, tmx.optimizer.Adam)
    assert all(isinstance(s, tuple) and len(s) == 2
               for s in mod._fused_opt_state.values())


# ---------------------------------------------------------------------------
# Updater states: round trip, and across the packages
# ---------------------------------------------------------------------------

def _trained_updater(pkg, name='adam', kw=None):
    params, grads = _steps(4, 3)
    upd = pkg.optimizer.get_updater(_opt(pkg, name, kw or {}))
    w = {k: pkg.nd.array(v) for k, v in params.items()}
    for g in grads:
        for i, k in enumerate(NAMES):
            upd(i, pkg.nd.array(g[k]), w[k])
    return upd


def _state_arrays(states):
    out = {}
    for idx, s in states.items():
        leaves = s if isinstance(s, (tuple, list)) else (s,)
        out[idx] = [None if x is None else x.asnumpy() for x in leaves]
    return out


def _assert_same_states(got, want):
    assert sorted(got) == sorted(want)
    for idx in want:
        assert len(got[idx]) == len(want[idx])
        for a, b in zip(got[idx], want[idx]):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name,kw', [('adam', {}), ('sgd', {'momentum': 0.9}),
                                     ('rmsprop', {'centered': True})])
def test_updater_states_round_trip(name, kw):
    upd = _trained_updater(tmx, name, kw)
    fresh = tmx.optimizer.get_updater(_opt(tmx, name, kw))
    fresh.set_states(upd.get_states())
    _assert_same_states(_state_arrays(fresh.states),
                        _state_arrays(upd.states))
    # and training goes on from them identically (the update count is
    # not part of the states)
    fresh.optimizer._index_update_count = dict(
        upd.optimizer._index_update_count)
    fresh.optimizer.num_update = upd.optimizer.num_update
    g = tmx.nd.array(np.ones((5, 3), np.float32))
    w1, w2 = (tmx.nd.array(np.zeros((5, 3), np.float32)) for _ in range(2))
    upd(0, g, w1)
    fresh(0, g, w2)
    np.testing.assert_array_equal(w1.asnumpy(), w2.asnumpy())


def test_reference_states_file_loads_into_the_port():
    """A ``.states`` file the JAX package wrote (NDArray states pickled
    with data, ctx_type and ctx_id, no dtype) loads into the port's
    Updater with the same values, and training continues as the JAX
    package's does."""
    jupd = _trained_updater(mx)
    tupd = tmx.optimizer.get_updater(_opt(tmx, 'adam', {}))
    tupd.set_states(jupd.get_states())
    assert all(isinstance(x, tmx.nd.NDArray)
               for s in tupd.states.values() for x in s)
    _assert_same_states(_state_arrays(tupd.states),
                        _state_arrays(jupd.states))
    # the repaired __setstate__ on the reference's state dict alone
    arr = tmx.nd.NDArray.__new__(tmx.nd.NDArray)
    arr.__setstate__({'data': np.arange(3, dtype=np.int32),
                      'ctx_type': 'cpu', 'ctx_id': 0})
    assert arr.dtype == torch.int32 and arr.asnumpy().tolist() == [0, 1, 2]
    # one more step from the loaded state: the same update as the JAX one
    jopt = jupd.optimizer
    tupd.optimizer._index_update_count = dict(jopt._index_update_count)
    tupd.optimizer.num_update = jopt.num_update
    g = np.full((5, 3), 0.5, np.float32)
    w0 = np.ones((5, 3), np.float32)
    jw, tw = mx.nd.array(w0), tmx.nd.array(w0)
    jupd(0, mx.nd.array(g), jw)
    tupd(0, tmx.nd.array(g), tw)
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=1e-5)


def test_port_states_file_loads_in_the_reference():
    """The reference's Updater.set_states reads a file the port wrote and
    gets the same values.  Its entries are the port's NDArrays (the class
    the pickle names): making them the reference's would need the port to
    name the JAX package's class in what it writes (ROADMAP Queue 3)."""
    tupd = _trained_updater(tmx)
    jupd = mx.optimizer.get_updater(_opt(mx, 'adam', {}))
    jupd.set_states(tupd.get_states())
    _assert_same_states(_state_arrays(jupd.states),
                        _state_arrays(tupd.states))


def test_states_pickles_name_each_package_class():
    """What the port's unpickler maps: the JAX package's states pickle
    names ``mxnet_tpu.ndarray NDArray``; the port's names its own."""
    assert b'mxnet_tpu.ndarray' in _trained_updater(mx).get_states()
    data = _trained_updater(tmx).get_states()
    assert b'mxnet_tpu_torch.ndarray' in data
    assert data.count(b'mxnet_tpu.ndarray') == 0


# ---------------------------------------------------------------------------
# the Updater loop keeps a low-precision weight's dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,kw', [
    ('nag', {'momentum': 0.9, 'wd': 1e-3, 'multi_precision': True}),
    ('adagrad', {'wd': 1e-3, 'multi_precision': True}),
])
def test_float16_weight_loop_equals_functional_form(name, kw):
    """A float16 weight through three ``Updater`` steps stays float16 and
    equals the port's functional form on the same tensors bit for bit
    (under ``multi_precision`` the state is float32).  On the parent the
    loop rebound the weight to the promoted float32 sum."""
    params, grads = _steps(n=3)
    topt = _opt(tmx, name, kw)
    upd = tmx.optimizer.get_updater(topt)
    w = {k: tmx.nd.array(v.astype(np.float16)) for k, v in params.items()}
    fopt = _opt(tmx, name, kw)
    idx = {k: i for i, k in enumerate(NAMES)}
    fo = fopt.make_functional(NAMES, idx)
    tp = {k: torch.from_numpy(v.astype(np.float16)) for k, v in
          params.items()}
    ts = fo.init(tp)
    for g in grads:
        for i, k in enumerate(NAMES):
            upd(i, tmx.nd.array(g[k]), w[k])
            fopt._update_count(i)
        fo.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                  fopt.host_lr())
    for i, k in enumerate(NAMES):
        assert w[k].dtype == torch.float16, (k, w[k].dtype)
        assert upd.states[i].dtype == torch.float32
        np.testing.assert_array_equal(w[k].asnumpy(), tp[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize('name,kw', [
    ('dcasgd', {'momentum': 0.9, 'wd': 1e-3}),
    ('dcasgd', {'momentum': 0.9, 'wd': 1e-3, 'multi_precision': True}),
    ('sgld', {'wd': 1e-3}),
])
def test_float16_weight_stays_float16_in_imperative_loops(name, kw):
    """DCASGD and SGLD have no functional form: a float16 weight stays
    float16 through three steps and follows the float32 weight's run of
    the same loop (SGLD's noise from the same seeded generator) within
    float16 rounding (atol 4e-3: three steps of half an ulp at |w| < 4)."""
    params, grads = _steps(n=3)
    out = {}
    for dtype in (np.float16, np.float32):
        tmx.random.seed(11)
        upd = tmx.optimizer.get_updater(_opt(tmx, name, kw))
        w = {k: tmx.nd.array(v.astype(dtype)) for k, v in params.items()}
        with tmx.cpu():
            for g in grads:
                for i, k in enumerate(NAMES):
                    upd(i, tmx.nd.array(g[k].astype(dtype)), w[k])
        out[dtype] = w
    for k in NAMES:
        assert out[np.float16][k].dtype == torch.float16, k
        np.testing.assert_allclose(
            out[np.float16][k].asnumpy().astype(np.float32),
            out[np.float32][k].asnumpy(), rtol=0, atol=4e-3, err_msg=k)
