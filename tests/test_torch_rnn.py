"""The sequence-model slice of the PyTorch port against the JAX package on
the CPU: the fused ``RNN`` op (``ops/rnn_op.py``) in its four modes, the
RNN cells (``rnn/rnn_cell.py``), the packed blob's pack/unpack, the
``FusedRNN`` initializer and the PTB LSTM language model
(``models/lstm_lm.py``) through ``make_train_step`` and
``BucketingModule``.

The same numpy inputs go to both packages.  Tolerances: forward float32
rtol 1e-5, atol 1e-6; gradients through the recurrence rtol 1e-4, atol
1e-5 (the summation order over T differs); symbol JSON, packing and
unpacking bit-exact.  Inter-layer dropout runs with p = 0: the packages'
generators differ."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import models as jmodels
from mxnet_tpu import rnn as jrnn
from mxnet_tpu.base import NameManager as JNames
from mxnet_tpu.ops import get_op as jax_op
from mxnet_tpu.ops import rnn_op as jrnn_op
from mxnet_tpu.parallel import train_step as jts
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import rnn as trnn
from mxnet_tpu_torch.base import NameManager as TNames
from mxnet_tpu_torch.ops import get_op as torch_op
from mxnet_tpu_torch.ops import rnn_op as trnn_op
from mxnet_tpu_torch.parallel import train_step as tts

R = np.random.RandomState(31)
MODES = ('lstm', 'gru', 'rnn_tanh', 'rnn_relu')
# (layers, bidirectional, use_state, state_outputs)
CONFIGS = {'one_layer': (1, False, False, False),
           'two_layers_bidirectional_states': (2, True, True, True),
           'two_layers_state_outputs': (2, False, False, True)}
T, N, I, H = 5, 3, 4, 6


def _rnn_case(mode, cfg):
    layers, bi, use_state, state_outputs = CONFIGS[cfg]
    dirs = 2 if bi else 1
    attrs = {'mode': mode, 'state_size': H, 'num_layers': layers,
             'bidirectional': bi, 'use_state': use_state,
             'state_outputs': state_outputs, 'p': 0.0}
    size = trnn_op.rnn_param_size(mode, I, H, layers, bi)
    inputs = [R.randn(T, N, I).astype(np.float32),
              (R.randn(size) * 0.4).astype(np.float32)]
    if use_state:
        inputs.append((R.randn(layers * dirs, N, H) * 0.5)
                      .astype(np.float32))
        if mode == 'lstm':
            inputs.append((R.randn(layers * dirs, N, H) * 0.5)
                          .astype(np.float32))
    return attrs, inputs


def _jax_vjp(attrs, inputs, cots, is_train=True):
    op = jax_op('RNN')
    attrs = op.canon_attrs(attrs)

    def f(*xs):
        return op.apply(attrs, list(xs), is_train, jax.random.PRNGKey(0))[0]

    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in inputs])
    grads = vjp([jnp.asarray(c) for c in cots])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_vjp(attrs, inputs, cots, is_train=True):
    op = torch_op('RNN')
    args = [torch.from_numpy(a.copy()).requires_grad_(True) for a in inputs]
    outs, _ = op.apply(op.canon_attrs(attrs), args, is_train, None)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
@pytest.mark.parametrize('mode', MODES)
def test_rnn_op_forward_and_gradients_match_jax(mode, cfg):
    attrs, inputs = _rnn_case(mode, cfg)
    probe = torch_op('RNN').apply(torch_op('RNN').canon_attrs(attrs),
                                  [torch.from_numpy(a) for a in inputs],
                                  True, None)[0]
    cots = [R.randn(*o.shape).astype(np.float32) for o in probe]
    touts, tgrads = _torch_vjp(attrs, inputs, cots)
    jouts, jgrads = _jax_vjp(attrs, inputs, cots)
    assert len(touts) == len(jouts) == torch_op('RNN').num_outputs(attrs)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6,
                                   err_msg='output %d' % k)
    for k, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                   err_msg='gradient of input %d' % k)


def test_rnn_op_inference_and_shape_inference():
    attrs, inputs = _rnn_case('lstm', 'two_layers_bidirectional_states')
    op = torch_op('RNN')
    touts, _ = op.apply(op.canon_attrs(attrs),
                        [torch.from_numpy(a) for a in inputs], False, None)
    jouts, _ = jax_op('RNN').apply(jax_op('RNN').canon_attrs(attrs),
                                   [jnp.asarray(a) for a in inputs], False,
                                   jax.random.PRNGKey(0))
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    shapes = {}
    for pkg in (tmx, mx):
        s = pkg.sym.RNN(data=pkg.sym.Variable('data'), state_size=H,
                        num_layers=2, bidirectional=True, mode='gru',
                        state_outputs=True, use_state=True, name='rnn')
        shapes[pkg] = s.infer_shape(data=(T, N, I))
    assert shapes[tmx] == shapes[mx]


def test_param_layout_matches_jax():
    for mode in MODES:
        for bi in (False, True):
            assert trnn_op.rnn_param_layout(mode, I, H, 3, bi) == \
                jrnn_op.rnn_param_layout(mode, I, H, 3, bi)


def test_dropout_between_layers_uses_the_port_generator():
    attrs, inputs = _rnn_case('lstm', 'two_layers_state_outputs')
    attrs['p'] = 0.5
    op = torch_op('RNN')
    args = [torch.from_numpy(a) for a in inputs]
    with tmx.cpu():
        tmx.random.seed(3)
        a = op.apply(op.canon_attrs(attrs), args, True, None)[0]
        tmx.random.seed(3)
        b = op.apply(op.canon_attrs(attrs), args, True, None)[0]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # inference ignores p: the fused call over every layer
    ev = op.apply(op.canon_attrs(attrs), args, False, None)[0]
    no_p = op.apply(op.canon_attrs(dict(attrs, p=0.0)), args, False,
                    None)[0]
    assert torch.equal(ev[0], no_p[0])


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _cells(pkg):
    r = pkg.rnn
    seq = r.SequentialRNNCell()
    seq.add(r.LSTMCell(5, prefix='s0_'))
    seq.add(r.DropoutCell(0.0, prefix='s_drop_'))
    seq.add(r.GRUCell(5, prefix='s1_'))
    return {
        'rnn_tanh': r.RNNCell(5, prefix='rnn_'),
        'rnn_relu': r.RNNCell(5, activation='relu', prefix='relu_'),
        'lstm': r.LSTMCell(5, prefix='lstm_'),
        'gru': r.GRUCell(5, prefix='gru_'),
        'fused_lstm': r.FusedRNNCell(5, num_layers=2, prefix='fl_'),
        'fused_gru_bi': r.FusedRNNCell(5, num_layers=2, mode='gru',
                                       bidirectional=True,
                                       get_next_state=True, prefix='fg_'),
        'fused_unfused': r.FusedRNNCell(5, num_layers=2, mode='lstm',
                                        bidirectional=True,
                                        prefix='fu_').unfuse(),
        'sequential': seq,
        'bidirectional': r.BidirectionalCell(r.LSTMCell(5, prefix='bl_'),
                                             r.LSTMCell(5, prefix='br_')),
        'zoneout': r.ZoneoutCell(r.GRUCell(5, prefix='z_'),
                                 zoneout_outputs=0.0, zoneout_states=0.0),
        'residual': r.ResidualCell(r.GRUCell(5, prefix='res_')),
    }


CELLS = sorted(_cells(tmx))


@pytest.mark.parametrize('layout', ['NTC', 'TNC'])
@pytest.mark.parametrize('name', CELLS)
def test_cell_unroll_json_matches_jax(name, layout):
    got = {}
    for pkg, names in ((tmx, TNames), (mx, JNames)):
        with names():
            cell = _cells(pkg)[name]
            data = pkg.sym.Variable('data')
            outs, states = cell.unroll(4, inputs=data, layout=layout,
                                       merge_outputs=True)
            got[pkg] = (outs.tojson(), cell.state_info,
                        [s.name for s in pkg.sym.Group(list(states))]
                        if states and not isinstance(states[0], list)
                        else None)
    assert got[tmx] == got[mx]


def test_cell_unroll_over_a_list_and_begin_state():
    got = {}
    for pkg, names in ((tmx, TNames), (mx, JNames)):
        with names():
            cell = pkg.rnn.LSTMCell(4, prefix='l_')
            begin = cell.begin_state()
            outs, _ = cell.unroll(3, begin_state=begin, merge_outputs=False)
            got[pkg] = (pkg.sym.Group(outs).tojson(),
                        [b.name for b in begin])
    assert got[tmx] == got[mx]


def _blob(cfg, num_input, hidden=5):
    mode, layers, bi = cfg
    size = trnn_op.rnn_param_size(mode, num_input, hidden, layers, bi)
    return (R.randn(size) * 0.4).astype(np.float32)


@pytest.mark.parametrize('cfg', [('lstm', 2, False), ('gru', 1, True),
                                 ('rnn_tanh', 2, True)],
                         ids=lambda c: '%s_%d_%s' % c)
def test_pack_unpack_bit_exact_against_jax(cfg):
    mode, layers, bi = cfg
    blob = _blob(cfg, 7)
    out = {}
    for pkg in (tmx, mx):
        cell = pkg.rnn.FusedRNNCell(5, num_layers=layers, mode=mode,
                                    bidirectional=bi, prefix='f_')
        args = cell.unpack_weights({'f_parameters': pkg.nd.array(blob)})
        packed = cell.pack_weights(dict(args))
        out[pkg] = ({k: v.asnumpy() for k, v in args.items()},
                    packed['f_parameters'].asnumpy())
    (targs, tpacked), (jargs, jpacked) = out[tmx], out[mx]
    assert sorted(targs) == sorted(jargs)
    for k in jargs:
        np.testing.assert_array_equal(targs[k], jargs[k], err_msg=k)
    np.testing.assert_array_equal(tpacked, blob)
    np.testing.assert_array_equal(jpacked, blob)


def test_gate_pack_unpack_bit_exact_against_jax():
    weights = {'g_i2h_weight': R.randn(12, 3).astype(np.float32),
               'g_i2h_bias': R.randn(12).astype(np.float32),
               'g_h2h_weight': R.randn(12, 4).astype(np.float32),
               'g_h2h_bias': R.randn(12).astype(np.float32)}
    out = {}
    for pkg in (tmx, mx):
        cell = pkg.rnn.GRUCell(4, prefix='g_')
        args = cell.unpack_weights({k: pkg.nd.array(v)
                                    for k, v in weights.items()})
        packed = cell.pack_weights(dict(args))
        out[pkg] = ({k: v.asnumpy() for k, v in args.items()},
                    {k: v.asnumpy() for k, v in packed.items()})
    for a, b in zip(out[tmx], out[mx]):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in weights.items():
        np.testing.assert_array_equal(out[tmx][1][k], v)


@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_unfuse_is_equivalent_to_the_fused_op(mode):
    """FusedRNNCell.unroll (one RNN op) and its unfuse() stack of cells,
    given the unpacked weights, compute the same outputs."""
    fused = trnn.FusedRNNCell(6, num_layers=2, mode=mode, prefix='u_')
    stack = fused.unfuse()
    data = tmx.sym.Variable('data')
    fout, _ = fused.unroll(5, inputs=data, layout='NTC', merge_outputs=True)
    sout, _ = stack.unroll(5, inputs=data, layout='NTC', merge_outputs=True)
    blob = _blob((mode, 2, False), 4, hidden=6)
    # the unpacked per-layer matrices are the unfused cells' parameters
    args = fused.unpack_weights({'u_parameters': tmx.nd.array(blob)})
    x = R.randn(3, 5, 4).astype(np.float32)
    res = []
    for sym, params in ((fout, {'u_parameters': tmx.nd.array(blob)}),
                        (sout, args)):
        begin = {n: (x.shape[0], 6) for n in sym.list_arguments()
                 if 'begin_state' in n}
        arg_shapes, _, _ = sym.infer_shape(data=x.shape, **begin)
        vals = {'data': tmx.nd.array(x)}
        for n, s in zip(sym.list_arguments(), arg_shapes):
            if n in params:
                vals[n] = params[n]
            elif n != 'data':
                vals[n] = tmx.nd.zeros(s)       # begin states
        exe = sym.bind(tmx.cpu(), vals)
        res.append(exe.forward()[0].asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('mode,bi', [('lstm', False), ('gru', True)])
def test_fused_rnn_initializer_matches_jax(mode, bi):
    """Orthogonal draws from numpy's global generator in both packages, so
    FusedRNN over it must give the same blob."""
    size = trnn_op.rnn_param_size(mode, 7, 5, 2, bi)
    blobs = []
    for init_mod, pkg in ((tinit, tmx), (jinit, mx)):
        init = init_mod.FusedRNN(init_mod.Orthogonal(), 5, 2, mode, bi)
        arr = pkg.nd.zeros((size,))
        np.random.seed(11)
        init(init_mod.InitDesc('lstm_parameters'), arr)
        blobs.append(arr.asnumpy())
    np.testing.assert_array_equal(blobs[0], blobs[1])
    assert np.abs(blobs[0]).sum() > 0


def test_default_dispatch_routes_blob_and_begin_states():
    arr = tmx.nd.zeros((40,))
    tinit.Constant(0.5)('lstm_parameters', arr)
    assert np.all(arr.asnumpy() == 0.5)
    st = tmx.nd.array(np.ones((2, 3)))
    tinit.Constant(0.5)('lstm_begin_state_0', st)
    assert np.all(st.asnumpy() == 0.0)


# ---------------------------------------------------------------------------
# the PTB LSTM language model
# ---------------------------------------------------------------------------

V, E, LH, LT, LN = 50, 16, 16, 5, 4
LM_CFG = dict(vocab_size=V, num_embed=E, num_hidden=LH, num_layers=2)
OPT = dict(lr=0.1, momentum=0.9, wd=0.0, rescale_grad=1.0 / LN)


def _lm_params(seq_len):
    sym = tmodels.get_symbol('lstm_lm', seq_len=seq_len, **LM_CFG)
    arg_shapes, _, _ = sym.infer_shape(data=(LN, seq_len),
                                       softmax_label=(LN, seq_len))
    rng = np.random.RandomState(0)
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ('data', 'softmax_label')}


def test_lstm_lm_json_matches_jax():
    for kw in ({}, LM_CFG):
        with TNames():
            a = tmodels.get_symbol('lstm_lm', **kw).tojson()
        with JNames():
            b = jmodels.get_symbol('lstm_lm', **kw).tojson()
        assert a == b


def test_lstm_lm_train_steps_match_jax():
    """The bench leg's make_train_step (SGD with momentum) at a narrow
    width, three steps from the same parameters and batches."""
    arg = _lm_params(LT)
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, V, (LN, LT)).astype(np.float32)
               for _ in range(3)]
    sym = tmodels.get_symbol('lstm_lm', seq_len=LT, **LM_CFG)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in arg.items()}
    tstep = tts.make_train_step(sym, tts.make_sgd_momentum(**OPT),
                                ('data', 'softmax_label'))
    tstate = tts.sgd_momentum_init(tparams)
    jsym = jmodels.get_symbol('lstm_lm', seq_len=LT, **LM_CFG)
    jparams = {k: jnp.asarray(v) for k, v in arg.items()}
    jstep = jts.make_train_step(jsym, jts.make_sgd_momentum(**OPT),
                                ('data', 'softmax_label'))
    jstate = jts.sgd_momentum_init(jparams)
    for toks in batches:
        labels = (toks + 1) % V
        touts, tparams, _, tstate = tstep(
            tparams, {}, tstate, {'data': torch.from_numpy(toks),
                                  'softmax_label': torch.from_numpy(labels)})
        jouts, jparams, _, jstate = jstep(
            jparams, {}, jstate, {'data': jnp.asarray(toks),
                                  'softmax_label': jnp.asarray(labels)},
            jax.random.PRNGKey(0))
        np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                                   rtol=1e-4, atol=1e-6)
    for k in arg:
        got, want = tparams[k].numpy(), np.asarray(jparams[k])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert np.max(np.abs(want - arg[k])) > 0, k


def test_bucketing_module_over_lstm_lm_matches_jax():
    """BucketingModule(lstm_lm.sym_gen_bucketing(...)) over buckets 5 and
    3 (the default 5), alternating, with the fused fit step."""
    arg = _lm_params(LT)
    opt = {'learning_rate': 0.1, 'momentum': 0.9}
    rng = np.random.RandomState(2)
    order = (LT, 3, LT, 3)
    mods = []
    for pkg, lm in ((tmx, tmodels.lstm_lm), (mx, jmodels.lstm_lm)):
        mod = pkg.mod.BucketingModule(lm.sym_gen_bucketing(**LM_CFG),
                                      default_bucket_key=LT,
                                      context=pkg.cpu())
        mod.bind(data_shapes=[('data', (LN, LT))],
                 label_shapes=[('softmax_label', (LN, LT))])
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in arg.items()})
        mod.init_optimizer(optimizer='sgd', optimizer_params=opt)
        mods.append(mod)
    metrics = (tmx.metric.create('ce'), mx.metric.create('ce'))
    for t in order:
        toks = rng.randint(0, V, (LN, t)).astype(np.float32)
        labels = (toks + 1) % V
        for pkg, mod, metric in zip((tmx, mx), mods, metrics):
            batch = pkg.io.DataBatch(
                [pkg.nd.array(toks)], [pkg.nd.array(labels)], bucket_key=t,
                provide_data=[('data', (LN, t))],
                provide_label=[('softmax_label', (LN, t))])
            mod._fit_step(batch, metric)
        tout, jout = (m.get_outputs()[0].asnumpy() for m in mods)
        assert tout.shape == (LN * t, V)
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-6,
                                   err_msg='bucket %d' % t)
    tp = {k: v.asnumpy() for k, v in mods[0].get_params()[0].items()}
    jp = {k: v.asnumpy() for k, v in mods[1].get_params()[0].items()}
    assert sorted(tp) == sorted(jp) == sorted(arg)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert sorted(mods[0]._buckets) == sorted(mods[1]._buckets) == [3, LT]
    assert metrics[0].get() == pytest.approx(metrics[1].get(), rel=1e-5)


def test_rnn_io_and_cells_are_exported():
    assert sorted(trnn.__all__) == sorted(
        n for n in dir(jrnn) if not n.startswith('_')
        and n not in ('io', 'rnn_cell'))
