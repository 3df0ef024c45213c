"""Checkpoints and the rest of the training lifecycle in the port, against
the JAX package on the CPU: ``.params`` and ``-symbol.json`` bytes,
``find_latest_checkpoint``, ``fit(checkpoint_prefix=, auto_resume=)``,
``module_checkpoint``/``do_checkpoint``, ``Module.load`` with optimizer
states and a resumed narrow-ResNet fit, checkpoints at two steps in
flight, ``FeedForward``, ``SequentialModule`` and ``PythonLossModule``.

The same numpy inputs and initial parameters go to both packages.
Tolerances: trained parameters rtol 1e-4, atol 1e-5 (float32 sums in
another order in the two frameworks, compounded over steps; as
tests/test_torch_train.py), MLP fits 2e-5; files written by the same
package from the same state are compared byte for byte."""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet as tresnet

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for knob in ('MXTPU_ASYNC_DEPTH', 'MXTPU_DEVICE_FEED', 'MXTPU_FUSED_FIT',
                 'MXTPU_AUTO_RESUME', 'MXTPU_WARM_START'):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv('MXTPU_FUSE', 'off')


def _mlp(pkg, nclass=4):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu', name='relu1')
    fc2 = pkg.sym.FullyConnected(act, num_hidden=nclass, name='fc2')
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _data(seed=0, n=64, d=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (rng.rand(n) * 4).astype(np.float32)
    init = {'fc1_weight': rng.uniform(-0.3, 0.3, (16, d)),
            'fc1_bias': np.zeros(16), 'fc2_weight':
            rng.uniform(-0.3, 0.3, (4, 16)), 'fc2_bias': np.zeros(4)}
    return x, y, {k: v.astype(np.float32) for k, v in init.items()}


def _arrays(pkg, d):
    return {k: pkg.nd.array(v) for k, v in d.items()}


def _numpy(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def test_checkpoint_files_byte_identical_across_packages(tmp_path):
    """save_checkpoint from the same symbol and arrays writes the same
    -symbol.json and .params bytes in both packages, and each package's
    load_checkpoint reads the other's."""
    _, _, init = _data()
    aux = {'bn_moving_var': np.linspace(0.5, 2, 16).astype(np.float32)}
    for pkg in (mx, tmx):
        pkg.model.save_checkpoint(str(tmp_path / pkg.__name__), 3,
                                  _mlp(pkg), _arrays(pkg, init),
                                  _arrays(pkg, aux))
    for suffix in ('-symbol.json', '-0003.params'):
        assert _read(tmp_path / ('mxnet_tpu' + suffix)) == \
            _read(tmp_path / ('mxnet_tpu_torch' + suffix))
    for reader, writer in ((tmx, mx), (mx, tmx)):
        sym, arg, aux_ = reader.model.load_checkpoint(
            str(tmp_path / writer.__name__), 3)
        assert sym.tojson() == _mlp(reader).tojson()
        for k, v in init.items():
            np.testing.assert_array_equal(arg[k].asnumpy(), v)
        np.testing.assert_array_equal(aux_['bn_moving_var'].asnumpy(),
                                      aux['bn_moving_var'])


def test_find_latest_checkpoint_skips_a_truncated_file(tmp_path):
    prefix = str(tmp_path / 'run')
    _, _, init = _data()
    for epoch in (1, 2):
        tmx.model.save_checkpoint(prefix, epoch, _mlp(tmx),
                                  _arrays(tmx, init), {})
    with open('%s-0009.params' % prefix, 'wb') as f:
        f.write(b'MXTPU001\x01')
    whole = _read('%s-0002.params' % prefix)
    with open('%s-0007.params' % prefix, 'wb') as f:
        f.write(whole[:-5])
    before = tmx.instrument.counter_value('checkpoint.corrupt_skipped')
    assert tmx.model.find_latest_checkpoint(prefix) == 2
    assert tmx.instrument.counter_value('checkpoint.corrupt_skipped') == \
        before + 2
    assert mx.model.find_latest_checkpoint(prefix) == 2
    assert tmx.model.loadable_epochs(prefix) == [1, 2] == \
        mx.model.loadable_epochs(prefix)
    assert tmx.nd.validate('%s-0001.params' % prefix)
    assert not tmx.nd.validate('%s-0007.params' % prefix)
    assert tmx.model.find_latest_checkpoint(str(tmp_path / 'none')) is None


def test_atomic_replace_keeps_the_previous_file(tmp_path):
    path = str(tmp_path / 'ckpt.params')
    with tmx.resilience.atomic_replace(path) as tmp:
        with open(tmp, 'wb') as f:
            f.write(b'first')
    with pytest.raises(RuntimeError):
        with tmx.resilience.atomic_replace(path) as tmp:
            with open(tmp, 'wb') as f:
                f.write(b'half of the sec')
            raise RuntimeError('killed mid-write')
    assert _read(path) == b'first'
    assert os.listdir(tmp_path) == ['ckpt.params']


# ---------------------------------------------------------------------------
# fit: per-epoch checkpoints and auto-resume
# ---------------------------------------------------------------------------

def _fit(pkg, prefix, num_epoch, init=None, **kw):
    x, y, init0 = _data()
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=num_epoch,
            checkpoint_prefix=prefix, optimizer_params={'learning_rate': 0.1},
            arg_params=_arrays(pkg, init if init is not None else init0),
            **kw)
    return mod


def test_fit_checkpoint_and_auto_resume_matches_jax(tmp_path):
    """The port's version of tests/test_resilience.py's fit test: two
    epochs with a checkpoint each, a truncated epoch-9 file, then a
    second module resumes from epoch 2 and writes 3 and 4; every file
    holds the JAX package's parameters."""
    for pkg in (mx, tmx):
        prefix = str(tmp_path / pkg.__name__)
        commits = tmx.instrument.counter_value('checkpoint.commits')
        _fit(pkg, prefix, 2)
        assert pkg.model.find_latest_checkpoint(prefix) == 2
        if pkg is tmx:
            assert tmx.instrument.counter_value('checkpoint.commits') == \
                commits + 2
        with open('%s-0009.params' % prefix, 'wb') as f:
            f.write(b'MXTPU001\x01')
        resumes = tmx.instrument.counter_value('checkpoint.resumes')
        mod2 = _fit(pkg, prefix, 4, auto_resume=True)
        if pkg is tmx:
            assert tmx.instrument.counter_value('checkpoint.resumes') == \
                resumes + 1
        # two epochs after the epoch-2 file, not four from the given init
        assert mod2._optimizer.num_update == 8
        assert pkg.model.find_latest_checkpoint(prefix) == 4
    for epoch in (1, 2, 3, 4):
        got = tmx.nd.load(str(tmp_path / ('mxnet_tpu_torch-%04d.params'
                                           % epoch)))
        want = tmx.nd.load(str(tmp_path / ('mxnet_tpu-%04d.params'
                                            % epoch)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize('knob', ['env', 'argument'])
def test_auto_resume_starts_after_the_newest_epoch(tmp_path, monkeypatch,
                                                   knob):
    """MXTPU_AUTO_RESUME=1 (or auto_resume=True) restarts from the newest
    loadable checkpoint: the resumed fit equals the JAX package's resumed
    fit, and a resume to the last epoch trains nothing."""
    kw = {}
    if knob == 'env':
        monkeypatch.setenv('MXTPU_AUTO_RESUME', '1')
    else:
        kw['auto_resume'] = True
    params = {}
    for pkg in (mx, tmx):
        prefix = str(tmp_path / pkg.__name__)
        monkeypatch.delenv('MXTPU_AUTO_RESUME', raising=False)
        _fit(pkg, prefix, 1)
        if knob == 'env':
            monkeypatch.setenv('MXTPU_AUTO_RESUME', '1')
        mod = _fit(pkg, prefix, 2, **kw)
        params[pkg] = _numpy(mod.get_params()[0])
        assert pkg.model.find_latest_checkpoint(prefix) == 2
    for k in params[mx]:
        np.testing.assert_allclose(params[tmx][k], params[mx][k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    before = tmx.instrument.counter_value('fit.batches')
    _fit(tmx, str(tmp_path / 'mxnet_tpu_torch'), 2, **kw)
    assert tmx.instrument.counter_value('fit.batches') == before


def test_checkpoint_period_and_last_epoch(tmp_path):
    prefix = str(tmp_path / 'p')
    _fit(tmx, prefix, 3, checkpoint_period=2)
    assert tmx.model.loadable_epochs(prefix) == [2, 3]


def test_module_checkpoint_and_do_checkpoint_match_jax(tmp_path):
    """The two epoch-end callbacks: module_checkpoint saves symbol,
    params and (asked) optimizer states; do_checkpoint the arrays it is
    given.  The port's .params equal the JAX package's written by the
    same callbacks."""
    for pkg in (mx, tmx):
        base = str(tmp_path / pkg.__name__)
        x, y, init = _data()
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
                arg_params=_arrays(pkg, init), epoch_end_callback=[
                    pkg.callback.module_checkpoint(
                        mod, base + '-mc', save_optimizer_states=True),
                    pkg.callback.do_checkpoint(base + '-do', period=2)])
        assert os.path.exists(base + '-mc-0002.states')
        assert pkg.model.loadable_epochs(base + '-mc') == [1, 2]
        assert pkg.model.loadable_epochs(base + '-do') == [2]
    for name in ('-mc-0001.params', '-mc-0002.params', '-do-0002.params'):
        got = tmx.nd.load(str(tmp_path / ('mxnet_tpu_torch' + name)))
        want = tmx.nd.load(str(tmp_path / ('mxnet_tpu' + name)))
        for k in want:
            np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    # the port's own two callbacks agree byte for byte
    assert _read(tmp_path / 'mxnet_tpu_torch-mc-0002.params') == \
        _read(tmp_path / 'mxnet_tpu_torch-do-0002.params')


def test_checkpoints_at_two_steps_in_flight_equal_one(tmp_path, monkeypatch):
    """A fit with two steps in flight and the device feed writes the same
    files, byte for byte, as a synchronous fit without the feed: each
    checkpoint reads the parameters and optimizer state after the step
    window has drained."""
    files = {}
    for depth, feed in ((2, '1'), (1, '0')):
        monkeypatch.setenv('MXTPU_ASYNC_DEPTH', str(depth))
        monkeypatch.setenv('MXTPU_DEVICE_FEED', feed)
        prefix = str(tmp_path / ('d%d' % depth))
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        x, y, init = _data()
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer='adam', checkpoint_prefix=prefix,
                arg_params=_arrays(tmx, init),
                epoch_end_callback=tmx.callback.module_checkpoint(
                    mod, prefix + '-mc', save_optimizer_states=True))
        files[depth] = {n[len(os.path.basename(prefix)):]:
                        _read(os.path.join(tmp_path, n))
                        for n in os.listdir(tmp_path)
                        if n.startswith(os.path.basename(prefix))
                        and not n.endswith('.states')}
        upd = tmx.optimizer.get_updater(tmx.optimizer.create('adam'))
        upd.set_states(_read(prefix + '-mc-0002.states'))
        files[depth]['states'] = {k: [s.asnumpy() for s in v]
                                  for k, v in upd.states.items()}
    states = [files[d].pop('states') for d in (1, 2)]
    assert files[2] == files[1] and len(files[1]) == 6
    for k in states[0]:
        for a, b in zip(states[0][k], states[1][k]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Module.load with optimizer states: a resumed narrow ResNet
# ---------------------------------------------------------------------------

def _resnet_case():
    sym = tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                         filter_list=[8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 64, 64))
    arg, aux = convert.random_params(sym, {'data': (4, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, 8).astype(np.float32)
    return sym, arg, aux, x, y


def test_resumed_resnet_fit_matches_jax(tmp_path, monkeypatch):
    """A narrow ResNet v2 (MXTPU_FUSE=aggressive, the JAX side in Pallas
    interpret mode) trains one epoch with module_checkpoint(...,
    save_optimizer_states=True); a Module.load(prefix, 1,
    load_optimizer_states=True) then fits epoch 2 (begin_epoch=1).  The
    port's resumed parameters equal the JAX package's, and, for SGD with
    momentum and no schedule, the port's uninterrupted two-epoch fit
    (the update count restarts, which SGD does not read)."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    sym, arg, aux, x, y = _resnet_case()
    resumed = {}
    for pkg in (mx, tmx):
        prefix = str(tmp_path / pkg.__name__)
        psym = pkg.sym.load_json(sym.tojson())
        mod = pkg.mod.Module(psym, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer='sgd', optimizer_params=OPT,
                arg_params=_arrays(pkg, arg), aux_params=_arrays(pkg, aux),
                epoch_end_callback=pkg.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True))
        mod2 = pkg.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                   context=pkg.cpu())
        mod2.fit(pkg.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                 begin_epoch=1, optimizer='sgd', optimizer_params=OPT)
        resumed[pkg] = [_numpy(d) for d in mod2.get_params()]
    straight = tmx.mod.Module(sym, context=tmx.cpu())
    straight.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                 optimizer='sgd', optimizer_params=OPT,
                 arg_params=_arrays(tmx, arg), aux_params=_arrays(tmx, aux))
    for got, want, full in zip(resumed[tmx], resumed[mx],
                               [_numpy(d) for d in straight.get_params()]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    moved = max(float(np.max(np.abs(resumed[tmx][0][k] - arg[k])))
                for k in arg)
    assert moved > 1e-3


def test_load_optimizer_states_writes_into_the_steps_state(tmp_path):
    """Loading a .states file into a module whose fused step holds state
    copies the values into those tensors (a captured step holds their
    addresses): the same tensor objects, the loaded values, and the next
    steps train as the module the file came from."""
    x, y, init = _data()
    src = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    src.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
            optimizer='adam', arg_params=_arrays(tmx, init))
    src.save_optimizer_states(str(tmp_path / 'a.states'))
    params = src.get_params()
    dst = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    dst.fit(tmx.io.NDArrayIter(x[:16], y[:16], batch_size=16), num_epoch=1,
            optimizer='adam', arg_params=_arrays(tmx, init))
    held = {k: tuple(v) for k, v in dst._fused_opt_state.items()}
    graphs = dict(dst._graphs)
    dst.set_params(*params)
    dst.load_optimizer_states(str(tmp_path / 'a.states'))
    for k, v in dst._fused_opt_state.items():
        assert all(a is b for a, b in zip(v, held[k]))
        for a, b in zip(v, src._fused_opt_state[k]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert graphs
    # the update count is not in the file: give dst src's
    counts = dict(src._optimizer._index_update_count)
    for m in (src, dst):
        m._optimizer._index_update_count = dict(counts)
        m._optimizer.num_update = max(counts.values())
        m.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
              begin_epoch=1, optimizer='adam')
    for k, v in src.get_params()[0].items():
        np.testing.assert_array_equal(dst.get_params()[0][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


# ---------------------------------------------------------------------------
# BaseModule / Module / Executor helpers
# ---------------------------------------------------------------------------

def test_save_load_params_iter_predict_and_reshape(tmp_path):
    x, y, init = _data()
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
            arg_params=_arrays(tmx, init))
    fname = str(tmp_path / 'm.params')
    mod.save_params(fname)
    jm = mx.mod.Module(_mlp(mx), context=mx.cpu())
    jm.bind([('data', (16, 8))], [('softmax_label', (16,))])
    jm.load_params(fname)
    other = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    other.bind([('data', (16, 8))], [('softmax_label', (16,))])
    other.load_params(fname)
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(other.get_params()[0][k].asnumpy(),
                                      v.asnumpy())
        np.testing.assert_array_equal(jm.get_params()[0][k].asnumpy(),
                                      v.asnumpy())
    it = tmx.io.NDArrayIter(x[:40], y[:40], batch_size=16)
    jit = mx.io.NDArrayIter(x[:40], y[:40], batch_size=16)
    got = [(o[0].asnumpy(), n, b.pad) for o, n, b in other.iter_predict(it)]
    want = [(o[0].asnumpy(), n, b.pad) for o, n, b in jm.iter_predict(jit)]
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert [g[0].shape for g in got] == [(16, 4), (16, 4), (8, 4)]
    for (a, _, _), (b, _, _) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert other.get_states(merge_multi_context=False) == []
    # reshape keeps the parameters (the same arrays) at a new batch size
    w = other._exec_group.execs[0].arg_dict['fc1_weight']
    other.reshape([('data', (5, 8))], [('softmax_label', (5,))])
    assert other._exec_group.execs[0].arg_dict['fc1_weight'] is w
    assert other.output_shapes == [('softmax_output', (5, 4))]
    other.forward(tmx.io.DataBatch([tmx.nd.array(x[:5])],
                                   [tmx.nd.array(y[:5])]), is_train=False)
    np.testing.assert_allclose(other.get_outputs()[0].asnumpy(),
                               got[0][0][:5], rtol=1e-5, atol=1e-6)


def test_executor_arrays_and_copy_params_in_place():
    exe = _mlp(tmx).simple_bind(tmx.cpu(), data=(2, 8))
    jexe = _mlp(mx).simple_bind(mx.cpu(), data=(2, 8))
    assert [a.shape for a in exe.arg_arrays] == \
        [a.shape for a in jexe.arg_arrays]
    assert len(exe.grad_arrays) == len(exe.arg_names)
    assert exe.aux_arrays == []
    before = exe.arg_dict['fc1_weight'].handle
    _, _, init = _data()
    exe.copy_params_from(_arrays(tmx, init))
    assert exe.arg_dict['fc1_weight'].handle is before
    np.testing.assert_array_equal(before.numpy(), init['fc1_weight'])
    with pytest.raises(ValueError):
        exe.copy_params_from({'nope': tmx.nd.zeros((1,))})
    exe.copy_params_from({'nope': tmx.nd.zeros((1,))},
                         allow_extra_params=True)


def test_get_input_grads_matches_jax():
    x, y, init = _data()
    grads = {}
    for pkg in (mx, tmx):
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.bind([('data', (16, 8))], [('softmax_label', (16,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params=_arrays(pkg, init))
        mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x[:16])],
                                              [pkg.nd.array(y[:16])]))
        grads[pkg] = mod.get_input_grads()[0].asnumpy()
    np.testing.assert_allclose(grads[tmx], grads[mx], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# FeedForward, SequentialModule, PythonLossModule
# ---------------------------------------------------------------------------

def test_feedforward_matches_jax(tmp_path):
    """FeedForward.create (a shuffled numpy X, roll-over batches), then
    predict, score, save and FeedForward.load, in both packages."""
    x, y, init = _data()
    out = {}
    for pkg in (mx, tmx):
        np.random.seed(3)
        model = pkg.model.FeedForward.create(
            _mlp(pkg), x, y, ctx=pkg.cpu(), num_epoch=2,
            numpy_batch_size=16, learning_rate=0.1, momentum=0.9,
            arg_params=_arrays(pkg, init))
        pred = model.predict(x[:20])
        acc = model.score(pkg.io.NDArrayIter(x, y, batch_size=16))
        prefix = str(tmp_path / pkg.__name__)
        model.save(prefix)
        back = pkg.model.FeedForward.load(prefix, 2, ctx=pkg.cpu())
        assert back.begin_epoch == 2
        np.testing.assert_array_equal(back.predict(x[:20]), pred)
        out[pkg] = (pred, acc, _numpy(model.arg_params))
    (tp, tacc, targ), (jp, jacc, jarg) = out[tmx], out[mx]
    assert tp.shape == (20, 4)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-6)
    assert tacc == jacc
    for k in jarg:
        np.testing.assert_allclose(targ[k], jarg[k], rtol=2e-5, atol=2e-5,
                                   err_msg=k)
    assert _read(tmp_path / 'mxnet_tpu_torch-symbol.json') == \
        _read(tmp_path / 'mxnet_tpu-symbol.json')


def _chain(pkg, loss):
    """fc1 + relu as one Module; fc2 + SoftmaxOutput as a second (or, with
    ``loss``, fc2 alone and a PythonLossModule whose gradient is
    softmax - onehot)."""
    data = pkg.sym.Variable('data')
    net1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=16, name='fc1'), act_type='relu', name='relu1')
    m1 = pkg.mod.Module(net1, label_names=None, context=pkg.cpu())
    fc2 = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=4,
                                 name='fc2')
    seq = pkg.mod.SequentialModule()
    seq.add(m1)
    if not loss:
        m2 = pkg.mod.Module(pkg.sym.SoftmaxOutput(fc2, name='softmax'),
                            context=pkg.cpu())
        return seq.add(m2, take_labels=True, auto_wiring=True)

    def grad(scores, labels):
        s = scores.asnumpy()
        p = np.exp(s - s.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
        return p
    m2 = pkg.mod.Module(fc2, label_names=None, context=pkg.cpu())
    seq.add(m2, auto_wiring=True)
    return seq.add(pkg.mod.PythonLossModule(data_names=['fc2_output'],
                                            grad_func=grad),
                   take_labels=True, auto_wiring=True)


@pytest.mark.parametrize('loss', [False, True], ids=['sequential',
                                                     'python_loss'])
def test_sequential_and_python_loss_module_fits_match_jax(loss):
    x, y, init = _data()
    got = {}
    for pkg in (mx, tmx):
        seq = _chain(pkg, loss)
        seq.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
                arg_params=_arrays(pkg, init), allow_missing=False,
                eval_metric='acc')
        got[pkg] = _numpy(seq.get_params()[0])
        assert seq.get_outputs()[0].shape == (16, 4)
    assert sorted(got[tmx]) == sorted(init)
    for k in init:
        np.testing.assert_allclose(got[tmx][k], got[mx][k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)
        assert np.max(np.abs(got[tmx][k] - init[k])) > 1e-4


def test_a_second_fit_keeps_the_step_for_a_fresh_metric():
    """Each fit makes a new metric from its string: one of the same
    device form (device_fold_key) takes over the fused step's
    accumulators, so a resumed fit keeps the step and its graphs, and
    the new metric counts only its own fit."""
    x, y, init = _data()
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
            arg_params=_arrays(tmx, init), eval_metric='acc')
    step, graphs = mod._fused, dict(mod._graphs)
    first = mod._fused_metric
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            begin_epoch=1, eval_metric='acc')
    assert mod._fused is step and mod._graphs == graphs
    assert mod._fused_metric is not first and first._dev_sum is None
    assert mod._fused_metric.num_inst == 64
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=3,
            begin_epoch=2, eval_metric='ce')
    assert mod._fused is not step
