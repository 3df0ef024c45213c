"""Monitors in the PyTorch port against the JAX package on the CPU:
``monitor.Monitor`` over ``Executor.set_monitor_callback``, the tap names
and stats of a narrow ResNet v2 (under MXTPU_FUSE=aggressive, so the taps
must come from the ORIGINAL symbol, not the fused program) and of an MLP,
``Module.fit(monitor=...)`` on the loop against the JAX loop fit,
``install_monitor`` on BucketingModule and SequentialModule, and a
monitored module never running the fused (captured) step.

Both packages get the same numpy parameters and batches.  Tolerances:
stats rtol 1e-5 (one float32 norm each, summed in another order);
trained parameters rtol 1e-4, atol 1e-5, those of
``tests/test_torch_train.py``."""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet as tresnet

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


def _mlp(pkg):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu', name='relu1')
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name='fc2')
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _mlp_params(seed=5):
    r = np.random.RandomState(seed)
    return {'fc1_weight': r.randn(8, 5).astype(np.float32) * 0.5,
            'fc1_bias': np.zeros(8, np.float32),
            'fc2_weight': r.randn(4, 8).astype(np.float32) * 0.5,
            'fc2_bias': np.zeros(4, np.float32)}


def _recording(pkg, interval, pattern, sort=True):
    """A Monitor whose toc_print keeps what it would log."""
    mon = pkg.monitor.Monitor(interval, pattern=pattern, sort=sort)
    mon.seen = []
    mon.toc_print = lambda: mon.seen.append(mon.toc())
    return mon


def _fit(pkg, sym, arg, aux, x, y, batch, mon, steps_epochs=1):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch),
            num_epoch=steps_epochs, optimizer='sgd', optimizer_params=OPT,
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
            aux_params={k: pkg.nd.array(v) for k, v in aux.items()},
            monitor=mon)
    return mod


def _assert_same_taps(tseen, jseen):
    assert len(tseen) == len(jseen)
    for tb, jb in zip(tseen, jseen):
        assert [(s, n) for s, n, _ in tb] == [(s, n) for s, n, _ in jb]
        for (_, name, tv), (_, _, jv) in zip(tb, jb):
            np.testing.assert_allclose(
                np.array(tv.split(), np.float32),
                np.array(jv.split(), np.float32), rtol=1e-5, atol=1e-7,
                err_msg=name)


def _assert_params(tm, jm):
    (ta, tx), (ja, jx) = tm.get_params(), jm.get_params()
    for mine, theirs in ((ta, ja), (tx, jx)):
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k].asnumpy(),
                                       theirs[k].asnumpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_monitored_mlp_fit_matches_jax(monkeypatch):
    """fit(monitor=Monitor(2, sort=True)) over 4 batches: the taps of
    batches 0 and 2 (every node output, then the executor's outputs,
    sorted by name), and the loop-trained parameters, against the JAX
    package's monitored fit."""
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    r = np.random.RandomState(3)
    x = r.randn(16, 5).astype(np.float32)
    y = r.randint(0, 4, 16).astype(np.float32)
    arg = _mlp_params()
    mons = {pkg: _recording(pkg, 2, '.*') for pkg in (tmx, mx)}
    mods = {pkg: _fit(pkg, _mlp(pkg), arg, {}, x, y, 4, mons[pkg])
            for pkg in (tmx, mx)}
    tseen, jseen = mons[tmx].seen, mons[mx].seen
    assert len(tseen) == 4
    assert [len(b) for b in tseen] == [5, 0, 5, 0]
    assert [n for _, n, _ in tseen[0]] == [
        'fc1_output', 'fc2_output', 'relu1_output', 'softmax_output',
        'softmax_output']
    _assert_same_taps(tseen, jseen)
    _assert_params(mods[tmx], mods[mx])


def test_monitored_resnet_taps_the_original_symbol(monkeypatch):
    """A narrow ResNet v2 under MXTPU_FUSE=aggressive, two monitored
    steps matching '.*(conv|fc).*': the taps name the ORIGINAL graph's
    convolutions (the fused program has none of them) and equal the JAX
    package's, as do the parameters after the loop's two updates.  The
    fused step never ran, and the monitored module counts one
    ``compile.capture_skipped``."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    batch, steps = 4, 2
    tsym = tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                          filter_list=[8, 16, 32, 64, 128], num_classes=10,
                          image_shape=(3, 64, 64))
    arg, aux = convert.random_params(tsym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    mons = {pkg: _recording(pkg, 1, '.*(conv|fc).*') for pkg in (tmx, mx)}
    fused0 = tmx.instrument.counter_value('module.fused_steps')
    skip0 = tmx.instrument.counter_value('compile.capture_skipped')
    tm = _fit(tmx, tsym, arg, aux, x, y, batch, mons[tmx])
    jm = _fit(mx, mx.sym.load_json(tsym.tojson()), arg, aux, x, y, batch,
              mons[mx])
    assert tmx.instrument.counter_value('module.fused_steps') == fused0
    assert tmx.instrument.counter_value('compile.capture_skipped') == \
        skip0 + 1
    assert tm._fused is None
    names = [n for _, n, _ in mons[tmx].seen[0]]
    convs = [n for n in names if 'conv' in n]
    assert len(convs) == 13 and 'fc1_output' in names
    program = tm._exec_group.execs[0]._program_symbol(True)
    assert not any(n.op == 'Convolution' and 'conv' in n.name
                   for n in program.topo_nodes() if 'stage' in n.name)
    _assert_same_taps(mons[tmx].seen, mons[mx].seen)
    _assert_params(tm, jm)


def test_monitor_defaults_match_jax():
    """No sort: taps in graph order; interval 3 activates batches 0 and
    3; ``toc`` outside an active batch returns nothing."""
    for pkg in (tmx, mx):
        mon = pkg.monitor.Monitor(3)
        assert mon.toc() == []
        steps = []
        for _ in range(4):
            mon.tic()
            steps.append(mon.activated)
            mon.activated = False
        assert steps == [True, False, False, True]
    r = np.random.RandomState(0)
    arg = _mlp_params()
    x = r.randn(4, 5).astype(np.float32)
    seen = {}
    for pkg in (tmx, mx):
        exe = _mlp(pkg).bind(pkg.cpu(), {
            'data': pkg.nd.array(x),
            'softmax_label': pkg.nd.array(np.zeros(4, np.float32)),
            **{k: pkg.nd.array(v) for k, v in arg.items()}})
        mon = pkg.monitor.Monitor(1, pattern='fc.*')
        mon.install(exe)
        mon.tic()
        exe.forward(is_train=False)
        seen[pkg] = mon.toc()
    assert [n for _, n, _ in seen[tmx]] == ['fc1_output', 'fc2_output',
                                           'softmax_output']
    _assert_same_taps([seen[tmx]], [seen[mx]])


def _bucket_gen(pkg):
    def sym_gen(key):
        data = pkg.sym.Variable('data')
        label = pkg.sym.Variable('softmax_label')
        flat = pkg.sym.Reshape(data, shape=(-1, 1), name='flat')
        fc = pkg.sym.FullyConnected(flat, num_hidden=3, name='fc')
        out = pkg.sym.SoftmaxOutput(fc, pkg.sym.Reshape(
            label, shape=(-1,), name='flat_label'), name='softmax')
        return out, ('data',), ('softmax_label',)
    return sym_gen


def _bucket_batch(pkg, key, seed):
    r = np.random.RandomState(seed)
    return pkg.io.DataBatch(
        [pkg.nd.array(r.randn(2, key).astype(np.float32))],
        [pkg.nd.array(r.randint(0, 3, (2, key)).astype(np.float32))],
        bucket_key=key, provide_data=[('data', (2, key))],
        provide_label=[('softmax_label', (2, key))])


def test_bucketing_install_monitor_matches_jax():
    """install_monitor on a BucketingModule taps every bound bucket; a
    bucket bound after the call is tapped too in the port (the reference
    taps only the buckets bound at the call, a recorded deviation, so the
    JAX side is compared on the bound buckets)."""
    r = np.random.RandomState(4)
    arg = {'fc_weight': r.randn(3, 1).astype(np.float32),
           'fc_bias': np.zeros(3, np.float32)}
    mods, mons = {}, {}
    for pkg in (tmx, mx):
        mod = pkg.mod.BucketingModule(_bucket_gen(pkg), default_bucket_key=6,
                                      context=pkg.cpu())
        mod.bind([('data', (2, 6))], [('softmax_label', (2, 6))])
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in arg.items()})
        mod.init_optimizer(optimizer_params=OPT)
        mod.switch_bucket(4, [('data', (2, 4))], [('softmax_label', (2, 4))])
        mons[pkg] = _recording(pkg, 1, '.*')
        mod.install_monitor(mons[pkg])
        mods[pkg] = mod
    for step, key in enumerate((6, 4, 6)):
        for pkg in (tmx, mx):
            mons[pkg].tic()
            mods[pkg].forward_backward(_bucket_batch(pkg, key, step))
            mods[pkg].update()
            mons[pkg].toc_print()
    _assert_same_taps(mons[tmx].seen, mons[mx].seen)
    # a bucket bound after install_monitor: tapped in the port
    mon = mons[tmx]
    mon.tic()
    mods[tmx].forward(_bucket_batch(tmx, 3, 9), is_train=False)
    mon.toc_print()
    assert 'fc_output' in [n for _, n, _ in mon.seen[-1]]
    assert mods[tmx]._buckets[3]._exec_group.execs[0] in mon.exes
    assert mods[tmx]._buckets[3]._fused_unavailable


def test_sequential_install_monitor_matches_jax():
    """install_monitor on a SequentialModule taps each member module."""
    r = np.random.RandomState(8)
    x = r.randn(4, 5).astype(np.float32)
    y = r.randint(0, 4, 4).astype(np.float32)
    arg = _mlp_params()
    seen = {}
    for pkg in (tmx, mx):
        data = pkg.sym.Variable('data')
        net1 = pkg.sym.Activation(pkg.sym.FullyConnected(
            data, num_hidden=8, name='fc1'), act_type='relu', name='relu1')
        net2 = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.Variable('data'), num_hidden=4, name='fc2'),
            name='softmax')
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(net1, label_names=None, context=pkg.cpu()))
        seq.add(pkg.mod.Module(net2, context=pkg.cpu()), take_labels=True,
                auto_wiring=True)
        it = pkg.io.NDArrayIter(x, y, batch_size=4)
        seq.bind(it.provide_data, it.provide_label)
        seq.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in arg.items()},
                        allow_missing=False)
        seq.init_optimizer(optimizer_params=OPT)
        mon = _recording(pkg, 1, '.*')
        seq.install_monitor(mon)
        assert len(mon.exes) == 2
        mon.tic()
        seq.forward_backward(next(iter(it)))
        seq.update()
        mon.toc_print()
        seen[pkg] = mon.seen
    assert [n for _, n, _ in seen[tmx][0]] == sorted(
        ['fc1_output', 'relu1_output', 'relu1_output', 'fc2_output',
         'softmax_output', 'softmax_output'])
    _assert_same_taps(seen[tmx], seen[mx])


def test_monitored_module_never_builds_the_fused_step(caplog):
    """A monitored Module keeps the loop: install_monitor drops a built
    fused step and its graphs, and the next fit trains forward, backward,
    update, counting one ``compile.capture_skipped`` ('monitor')."""
    r = np.random.RandomState(1)
    x = r.randn(8, 5).astype(np.float32)
    y = r.randint(0, 4, 8).astype(np.float32)
    mod = tmx.Module(_mlp(tmx), context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=4)
    mod.fit(it, num_epoch=1, optimizer_params=OPT,
            arg_params={k: tmx.nd.array(v) for k, v in _mlp_params().items()})
    assert mod._fused is not None
    fused0 = tmx.instrument.counter_value('module.fused_steps')
    skip0 = tmx.instrument.counter_value('compile.capture_skipped')
    mon = tmx.monitor.Monitor(1)
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer_params=OPT, monitor=mon,
                force_init=False)
    assert mod._fused is None and mod._graphs == {}
    assert tmx.instrument.counter_value('module.fused_steps') == fused0
    assert tmx.instrument.counter_value('compile.capture_skipped') == \
        skip0 + 1
    assert 'stays eager: monitor' in caplog.text
    assert 'Batch:' in caplog.text

