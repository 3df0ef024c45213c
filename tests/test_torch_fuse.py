"""The port's step-compiler pipeline (mxnet_tpu_torch/fuse.py) against the
JAX package's (mxnet_tpu/fuse.py): the same rewritten graph, pass by
pass, computing the same values and gradients.  The JAX side runs with
its kernel paths live (MXTPU_FORCE_PALLAS_INTERPRET), which is where its
bn_relu_conv and nhwc_regions passes and its epilogue lowering run; the
port runs them always."""
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fuse as jfuse
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu_torch import fuse as tfuse


@pytest.fixture(scope='module')
def resnet50_json():
    return jax_resnet.get_symbol(num_classes=1000, num_layers=50).tojson()


def _ops(sym):
    return Counter(n.op for n in sym.topo_nodes() if not n.is_variable)


def _names(sym):
    return [(n.op, n.name) for n in sym.topo_nodes()]


def test_resnet50_inference_graph_matches_jax(resnet50_json, monkeypatch):
    # the JAX side with its kernel paths live (interpret forced), as it
    # runs on a TPU
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    jout = jfuse.apply_fuse_passes(mx.sym.load_json(resnet50_json), False,
                                   'aggressive')
    jstats = jfuse.last_run_stats()
    tout = tfuse.apply_fuse_passes(tmx.sym.load_json(resnet50_json), False,
                                   'aggressive')
    tstats = tfuse.last_run_stats()
    assert _ops(tout) == _ops(jout)
    assert _ops(tout) == Counter({
        '_conv_bn_folded': 33, 'Activation': 33, 'Convolution': 20,
        '_bn_relu': 17, '_plus': 16, 'Pooling': 2, 'BatchNorm': 1,
        'Flatten': 1, 'FullyConnected': 1, 'SoftmaxOutput': 1})
    assert _names(tout) == _names(jout)
    assert tstats == jstats
    assert tstats['passes']['conv_bn_fold']['rewrites'] == 33
    assert tstats['passes']['bn_relu']['rewrites'] == 17
    assert tstats['passes']['bn_relu_conv']['rewrites'] == 0


@pytest.mark.parametrize('mode', ['off', 'safe'])
def test_resnet50_lower_modes_match_jax(resnet50_json, mode):
    tsym = tmx.sym.load_json(resnet50_json)
    tout = tfuse.apply_fuse_passes(tsym, False, mode)
    jout = jfuse.apply_fuse_passes(mx.sym.load_json(resnet50_json), False,
                                   mode)
    assert _names(tout) == _names(jout)
    if mode == 'off':
        assert tout is tsym


def test_resnet50_training_needs_unported_kernels(resnet50_json,
                                                  monkeypatch):
    """Training keeps live BN statistics, so 52 BN->relu->conv chains go
    to bn_relu_conv — kernels this port now has: the aggressive training
    graph equals the JAX one node for node, layout transposes
    included."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    jout = jfuse.apply_fuse_passes(mx.sym.load_json(resnet50_json), True,
                                   'aggressive')
    jstats = jfuse.last_run_stats()
    tout = tfuse.apply_fuse_passes(tmx.sym.load_json(resnet50_json), True,
                                   'aggressive')
    tstats = tfuse.last_run_stats()
    assert _names(tout) == _names(jout)
    assert tstats == jstats
    ops = _ops(tout)
    assert ops['_bn_relu_conv'] == 52 and ops['Convolution'] == 1
    assert ops['_bn_relu'] == 2
    layouts = [(n.name, n.attrs.get('in_layout'), n.attrs.get('out_layout'))
               for n in tout.topo_nodes() if n.op == '_bn_relu_conv']
    assert layouts == [
        (n.name, n.attrs.get('in_layout'), n.attrs.get('out_layout'))
        for n in jout.topo_nodes() if n.op == '_bn_relu_conv']
    # one region: a single transpose back to NCHW, after the last residual
    # add (auto-named, so its number depends on what was built before)
    transposes = sorted(n.name for n in tout.topo_nodes()
                        if n.op == 'transpose')
    assert transposes == sorted(n.name for n in jout.topo_nodes()
                                if n.op == 'transpose')
    assert len(transposes) == 1 and transposes[0].startswith('plus') and \
        transposes[0].endswith('_to_nchw')


def _bn_relu_conv(pkg):
    data = pkg.sym.Variable('data')
    bn = pkg.sym.BatchNorm(data, fix_gamma=False, name='bn')
    act = pkg.sym.Activation(bn, act_type='relu', name='relu')
    return pkg.sym.Convolution(act, num_filter=4, kernel=(1, 1),
                               no_bias=True, name='conv')


def test_unported_bn_relu_conv_lowering_raises(monkeypatch):
    """No conv->BN pair to fold: the chain becomes one _bn_relu_conv node
    in both packages, and computes what the JAX node computes;
    skipping the pass takes the graph the JAX reference path builds."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    jout = jfuse.apply_fuse_passes(_bn_relu_conv(mx), False, 'aggressive')
    tout = tfuse.apply_fuse_passes(_bn_relu_conv(tmx), False, 'aggressive')
    assert _names(tout) == _names(jout)
    assert _ops(tout) == Counter({'_bn_relu_conv': 1, 'transpose': 1})
    r = np.random.RandomState(5)
    args = {'data': r.randn(2, 3, 5, 5).astype(np.float32),
            'bn_gamma': (r.rand(3) + 0.5).astype(np.float32),
            'bn_beta': r.randn(3).astype(np.float32),
            'conv_weight': r.randn(4, 3, 1, 1).astype(np.float32)}
    aux = {'bn_moving_mean': r.randn(3).astype(np.float32) * 0.1,
           'bn_moving_var': (r.rand(3) + 0.5).astype(np.float32)}
    got = tout.bind(tmx.cpu(), {k: tmx.nd.array(v) for k, v in args.items()},
                    aux_states={k: tmx.nd.array(v) for k, v in aux.items()}) \
        .forward()[0].asnumpy()
    want = jout.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in args.items()},
                     grad_req='null',
                     aux_states={k: mx.nd.array(v) for k, v in aux.items()}) \
        .forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv('MXTPU_FUSE_SKIP', 'bn_relu_conv')
    monkeypatch.delenv('MXTPU_FORCE_PALLAS_INTERPRET')
    tout = tfuse.apply_fuse_passes(_bn_relu_conv(tmx), False, 'aggressive')
    jout = jfuse.apply_fuse_passes(_bn_relu_conv(mx), False, 'aggressive')
    assert _names(tout) == _names(jout)
    assert '_bn_relu' in _ops(tout)


def _shape_class_net(pkg, kernel, stride, shortcut):
    """BN->relu->conv for one conv shape class (tests/test_fuse_bn_conv.py
    :168-185); with ``shortcut`` the relu feeds two fusable convs whose
    sum is the head."""
    sym = pkg.sym
    data = sym.Variable('data')
    bn = sym.BatchNorm(data, fix_gamma=False, eps=1e-3, name='bn1')
    act = sym.Activation(bn, act_type='relu', name='relu1')
    pad = (1, 1) if kernel == (3, 3) else (0, 0)
    conv = sym.Convolution(act, num_filter=8, kernel=kernel, stride=stride,
                           pad=pad, no_bias=True, name='conv1')
    if shortcut:
        sc = sym.Convolution(act, num_filter=8, kernel=(1, 1),
                             stride=stride, no_bias=True, name='sc')
        conv = conv + sc
    pool = sym.Pooling(conv, global_pool=True, kernel=(2, 2),
                       pool_type='avg', name='pool')
    return sym.SoftmaxOutput(sym.Flatten(pool, name='flat'), name='softmax')


@pytest.mark.parametrize('kernel,stride,shortcut', [
    ((3, 3), (1, 1), False),
    ((3, 3), (2, 2), False),
    ((1, 1), (2, 2), False),
    ((3, 3), (2, 2), True),      # shared relu: conv + projection
], ids=['3x3s1', '3x3s2', '1x1s2', '3x3s2+proj'])
def test_bn_relu_conv_shape_classes_match_jax(kernel, stride, shortcut,
                                              monkeypatch):
    """Every fusable conv shape class of the training graph: the fused
    node's forward, aux updates and gradients through the Executor
    (training forward + backward) match the JAX Executor's on the same
    fused graph (rtol 1e-4, atol 1e-5 as tests/test_fuse_bn_conv.py)."""
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    r = np.random.RandomState(0)
    vals = {'data': r.randn(4, 6, 8, 8).astype(np.float32),
            'bn1_gamma': (r.rand(6) + 0.5).astype(np.float32),
            'bn1_beta': r.randn(6).astype(np.float32),
            'conv1_weight': (r.randn(8, 6, *kernel) * 0.3).astype(np.float32),
            'softmax_label': r.randint(0, 8, 4).astype(np.float32)}
    if shortcut:
        vals['sc_weight'] = (r.randn(8, 6, 1, 1) * 0.3).astype(np.float32)
    aux = {'bn1_moving_mean': np.zeros(6, np.float32),
           'bn1_moving_var': np.ones(6, np.float32)}
    res = {}
    for pkg in (tmx, mx):
        # a fresh name scope: the residual add is auto-named
        with pkg.base.NameManager():
            net = _shape_class_net(pkg, kernel, stride, shortcut)
        exe = net.simple_bind(pkg.cpu(), grad_req='write', data=(4, 6, 8, 8))
        for k, v in vals.items():
            exe.arg_dict[k][:] = v
        for k, v in aux.items():
            exe.aux_dict[k][:] = v
        exe.forward(is_train=True)
        exe.backward()
        prog = exe._program_symbol(True)
        res[pkg] = (_names(prog), exe.outputs[0].asnumpy(),
                    {k: v.asnumpy() for k, v in exe.aux_dict.items()},
                    {k: v.asnumpy() for k, v in exe.grad_dict.items()})
    tnames, tout, taux, tgrad = res[tmx]
    jnames, jout, jaux, jgrad = res[mx]
    assert tnames == jnames
    assert Counter(op for op, _ in tnames)['_bn_relu_conv'] == \
        (2 if shortcut else 1)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert set(tgrad) == set(jgrad)
    for k in jgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _fc_relu(pkg):
    data = pkg.sym.Variable('data')
    fc = pkg.sym.FullyConnected(data, num_hidden=5, name='fc')
    return pkg.sym.Activation(fc, act_type='relu', name='fc_relu')


def _fc_clip(pkg, double_clip):
    """FC -> relu -> clip [-> clip] (tests/test_fuse_passes.py:352-359)."""
    sym = pkg.sym
    fc = sym.FullyConnected(sym.Variable('data'), num_hidden=8, name='fc')
    c = sym.clip(sym.Activation(fc, act_type='relu', name='r'),
                 a_min=-1.0, a_max=0.5, name='cl')
    if double_clip:
        c = sym.clip(c, a_min=0.0, a_max=0.4, name='cl2')
    return c


def _fc_args(seed, scale):
    r = np.random.RandomState(seed)
    return {'data': r.randn(64, 32).astype(np.float32),
            'fc_weight': r.randn(8, 32).astype(np.float32) * scale,
            'fc_bias': r.randn(8).astype(np.float32)}


def _forward(pkg, sym, args):
    kw = {} if pkg is tmx else {'grad_req': 'null'}
    return sym.bind(pkg.cpu(), {k: pkg.nd.array(v) for k, v in args.items()},
                    **kw).forward()[0].asnumpy()


def test_unported_fc_epilogue_lowering_raises(monkeypatch):
    """The aggressive epilogue pass now lowers FC -> relu -> clip onto
    fused_dot_epilogue as the JAX package does with its kernels live:
    the same fused graph, stamped ``lower_kernel``, computing the JAX
    result through the kernel's plain version (one launch-free call on
    the CPU), and the unfused chain's result."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    tout = tfuse.apply_fuse_passes(_fc_clip(tmx, False), True, 'aggressive')
    jout = jfuse.apply_fuse_passes(_fc_clip(mx, False), True, 'aggressive')
    assert _names(tout) == _names(jout)
    assert _ops(tout) == Counter({'_fused_epilogue': 1})
    node = [n for n in tout.topo_nodes() if n.op == '_fused_epilogue'][0]
    assert node.attrs['lower_kernel'] is True
    args = _fc_args(3, 0.3)
    calls = []
    real = tfuse.fused_dot_epilogue
    monkeypatch.setattr(tfuse, 'fused_dot_epilogue',
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = _forward(tmx, tout, args)
    assert calls == [{'relu': True, 'clip': (-1.0, 0.5)}]
    np.testing.assert_allclose(got, _forward(mx, jout, args), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        got, np.clip(np.maximum(args['data'] @ args['fc_weight'].T
                                + args['fc_bias'], 0), -1.0, 0.5),
        rtol=1e-5, atol=1e-6)


def test_epilogue_double_clip_keeps_exact_replay(monkeypatch):
    """FC -> relu -> clip -> clip: the kernel cannot express two clips,
    so the aggressive node falls back to the exact replay in both
    packages (tests/test_fuse_passes.py:392-411), bit for bit the unfused
    graph's result."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    tout = tfuse.apply_fuse_passes(_fc_clip(tmx, True), True, 'aggressive')
    jout = jfuse.apply_fuse_passes(_fc_clip(mx, True), True, 'aggressive')
    assert _names(tout) == _names(jout)
    assert tfuse.last_run_stats()['passes']['epilogue']['rewrites'] == 1
    monkeypatch.setattr(tfuse, 'fused_dot_epilogue', None)   # never called
    args = _fc_args(4, 0.5)
    got = _forward(tmx, tout, args)
    np.testing.assert_array_equal(got, _forward(tmx, _fc_clip(tmx, True),
                                                args))
    np.testing.assert_allclose(got, _forward(mx, jout, args), rtol=1e-5,
                               atol=1e-6)


def test_safe_epilogue_replay_matches_jax():
    """Under 'safe' the epilogue pass replays the chain exactly; the
    fused graph runs through the Executor and matches the JAX one."""
    r = np.random.RandomState(3)
    x = r.randn(3, 7).astype(np.float32)
    w = r.randn(5, 7).astype(np.float32)
    b = r.randn(5).astype(np.float32)
    tout = tfuse.apply_fuse_passes(_fc_relu(tmx), False, 'safe')
    jout = jfuse.apply_fuse_passes(_fc_relu(mx), False, 'safe')
    assert _names(tout) == _names(jout)
    assert tfuse.last_run_stats()['passes']['epilogue']['rewrites'] == 1
    args = {'data': x, 'fc_weight': w, 'fc_bias': b}
    got = tmx.sym.load_json(tout.tojson()).bind(
        tmx.cpu(), {k: tmx.nd.array(v) for k, v in args.items()}) \
        .forward()[0].asnumpy()
    want = jout.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in args.items()},
                     grad_req='null').forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.maximum(x @ w.T + b, 0), rtol=1e-5,
                               atol=1e-5)


def test_dead_branch_matches_jax():
    def build(pkg):
        data = pkg.sym.Variable('data')
        ident = pkg.sym.identity(data, name='ident')
        bn = pkg.sym.BatchNorm(ident, output_mean_var=True, name='bn')
        return pkg.sym.Activation(bn[0], act_type='relu', name='out')
    tout, tn = tfuse.prune_dead_branches(build(tmx))
    jout, jn = jfuse.prune_dead_branches(build(mx))
    assert tn == jn == 2
    assert _names(tout) == _names(jout)


def test_conv_bn_fold_numerics_match_jax():
    """A folded conv->BN node computes what the unfolded pair does, in
    both packages."""
    def build(pkg):
        data = pkg.sym.Variable('data')
        conv = pkg.sym.Convolution(data, num_filter=6, kernel=(3, 3),
                                   pad=(1, 1), no_bias=True, name='c')
        return pkg.sym.BatchNorm(conv, fix_gamma=False, eps=2e-5, name='b')
    r = np.random.RandomState(4)
    args = {'data': r.randn(2, 3, 8, 8).astype(np.float32),
            'c_weight': r.randn(6, 3, 3, 3).astype(np.float32),
            'b_gamma': (r.rand(6) + 0.5).astype(np.float32),
            'b_beta': r.randn(6).astype(np.float32)}
    aux = {'b_moving_mean': r.randn(6).astype(np.float32) * 0.1,
           'b_moving_var': (r.rand(6) + 0.5).astype(np.float32)}
    tsym, tn = tfuse.fold_conv_bn(build(tmx))
    assert tn == 1
    got = tsym.bind(tmx.cpu(), {k: tmx.nd.array(v) for k, v in args.items()},
                    aux_states={k: tmx.nd.array(v) for k, v in aux.items()}) \
        .forward()[0].asnumpy()
    plain = build(tmx).bind(
        tmx.cpu(), {k: tmx.nd.array(v) for k, v in args.items()},
        aux_states={k: tmx.nd.array(v) for k, v in aux.items()}) \
        .forward()[0].asnumpy()
    jsym, _ = jfuse.fold_conv_bn(build(mx))
    want = jsym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in args.items()},
                     grad_req='null',
                     aux_states={k: mx.nd.array(v) for k, v in aux.items()}) \
        .forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_bad_knobs_raise(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'turbo')
    with pytest.raises(ValueError):
        tfuse.fuse_mode()
    monkeypatch.setenv('MXTPU_FUSE', 'safe')
    monkeypatch.setenv('MXTPU_FUSE_SKIP', 'no_such_pass')
    with pytest.raises(ValueError):
        tfuse.apply_fuse_passes(_fc_relu(tmx), False)


def _const_net(pkg):
    """A constant subgraph (``_ones * 2 + _arange``) feeding a
    FullyConnected through a residual add."""
    sym = pkg.sym
    with pkg.base.NameManager():
        const = sym._ones(shape=(3, 4)) * 2.0 + \
            sym._arange(start=0, stop=4, name='ramp')
        return sym.FullyConnected(sym.Variable('data') + const,
                                  num_hidden=5, name='fc')


def test_fold_constants_matches_jax():
    """The _ones/_arange subgraph folds into one _graph_constant in both
    packages: the same rewrite count, graph, constant value and forward
    output as the unfolded graph."""
    tout, tn = tfuse.fold_constants(_const_net(tmx))
    jout, jn = jfuse.fold_constants(_const_net(mx))
    assert tn == jn == 1
    assert _names(tout) == _names(jout)
    tconst, jconst = [[n.attrs for n in s.topo_nodes()
                       if n.op == '_graph_constant'] for s in (tout, jout)]
    assert len(tconst) == 1
    assert tconst[0]['dtype'] == jconst[0]['dtype'] == 'float32'
    assert tuple(tconst[0]['shape']) == tuple(jconst[0]['shape']) == (3, 4)
    np.testing.assert_array_equal(np.array(tconst[0]['value']),
                                  np.array(jconst[0]['value']))
    r = np.random.RandomState(9)
    args = {'data': r.randn(3, 4).astype(np.float32),
            'fc_weight': r.randn(5, 4).astype(np.float32),
            'fc_bias': r.randn(5).astype(np.float32)}
    got = _forward(tmx, tmx.sym.load_json(tout.tojson()), args)
    np.testing.assert_array_equal(got, _forward(tmx, _const_net(tmx), args))
    np.testing.assert_allclose(got, _forward(mx, jout, args), rtol=1e-5,
                               atol=1e-6)
    # the pipeline runs it first: the safe pipeline folds the same
    tfuse.apply_fuse_passes(_const_net(tmx), False, 'safe')
    assert tfuse.last_run_stats()['passes']['constant_fold'][
        'rewrites'] == 1
