"""The bucketing slice of the PyTorch port against the JAX package on the
CPU: ``BucketingModule`` over ``transformer_lm.sym_gen_bucketing`` (the
narrow LM of ``tests/test_models.py``'s bucketing test, with V=300 so
that ids above 256 would show a bf16 rounding), ``rnn.BucketSentenceIter``,
``fit(warm_start=...)`` and ``MXTPU_PRECOMPILE_BUCKETS``; and the three
repairs this path needs: ``Embedding`` reads ids as ``jnp.take`` does (-1
wraps, an id outside [-V, V) gives a NaN row and no gradient),
``SoftmaxOutput`` gives a zero one-hot row to a label outside [0, C), and
a bf16 ``Module`` never casts token ids.

Both packages get the same numpy parameters (N(0, 0.02²),
``convert.random_params(..., init='normal')``) and batches, under
MXTPU_FUSE=aggressive, the JAX side's Pallas kernels interpreted.
Tolerances, those of ``tests/test_torch_lm.py``: outputs rtol 1e-4, atol
1e-6; parameters after each step rtol 1e-5, atol 1e-6; after a fit of
several steps rtol 1e-4, atol 1e-5.  The ops' repairs are exact or
float32 rounding (rtol 1e-6)."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import metric as jmetric
from mxnet_tpu.models import transformer_lm as jlm
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import compile_cache, convert
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops import registry as treg

V, E, HEADS, LAYERS, MAX_T, N = 300, 32, 2, 1, 16, 4
CFG = dict(vocab_size=V, num_embed=E, num_heads=HEADS, num_layers=LAYERS,
           max_seq_len=MAX_T)
ORDER = (16, 8, 12, 8, 16)
OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


@pytest.fixture(autouse=True)
def _aggressive_interpreted(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    monkeypatch.delenv('MXTPU_PRECOMPILE_BUCKETS', raising=False)
    monkeypatch.delenv('MXTPU_WARM_START', raising=False)


@pytest.fixture(scope='module')
def arg():
    sym = tlm.sym_gen_bucketing(**CFG)(MAX_T)[0]
    shapes = {'data': (N, MAX_T), 'softmax_label': (N, MAX_T)}
    return convert.random_params(sym, shapes, 0, init='normal')[0]


def _batches():
    """The fixed bucket order, then a 12-bucket batch whose rows end in
    ids and labels of -1 (the iterator's padding)."""
    rng = np.random.RandomState(1)
    out = []
    for t in ORDER + (12,):
        toks = rng.randint(0, V, (N, t)).astype(np.float32)
        labels = (toks + 1) % V
        out.append((t, toks, labels))
    toks, labels = out[-1][1], out[-1][2]
    toks[:, 9:] = -1
    labels[:, 8:] = -1
    return out


def _batch(pkg, t, toks, labels):
    return pkg.io.DataBatch([pkg.nd.array(toks)], [pkg.nd.array(labels)],
                            bucket_key=t,
                            provide_data=[('data', (N, t))],
                            provide_label=[('softmax_label', (N, t))])


def _module(pkg, lm, arg, **kw):
    mod = pkg.mod.BucketingModule(lm.sym_gen_bucketing(**CFG),
                                  default_bucket_key=MAX_T,
                                  context=pkg.cpu(), **kw)
    mod.bind(data_shapes=[('data', (N, MAX_T))],
             label_shapes=[('softmax_label', (N, MAX_T))])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
    mod.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_bucketed_fused_steps_match_jax(arg):
    """Alternating buckets through the fused fit step, then a -1-padded
    batch: outputs and every parameter after every step."""
    mods = (_module(tmx, tlm, arg), _module(mx, jlm, arg))
    metrics = (tmx.metric.create('acc'), mx.metric.create('acc'))
    for t, toks, labels in _batches():
        for pkg, mod, metric in zip((tmx, mx), mods, metrics):
            mod._fit_step(_batch(pkg, t, toks, labels), metric)
        tout, jout = (m.get_outputs()[0].asnumpy() for m in mods)
        assert tout.shape == (N * t, V)
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-6,
                                   err_msg='bucket %d' % t)
        tp, jp = _params(mods[0]), _params(mods[1])
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                       err_msg='%s after bucket %d' % (k, t))
    assert sorted(mods[0]._buckets) == sorted(mods[1]._buckets) == [8, 12, 16]
    assert metrics[0].get() == pytest.approx(metrics[1].get())


def test_buckets_share_the_default_buckets_arrays(arg):
    mod = _module(tmx, tlm, arg)
    for t, toks, labels in _batches()[:3]:
        mod._fit_step(_batch(tmx, t, toks, labels), tmx.metric.create('acc'))
    default = mod._buckets[MAX_T]
    dexec = default._exec_group.execs[0]
    assert dexec.arg_dict['pos_embed_weight'].shape == (MAX_T, E)
    for key in (8, 12):
        bucket = mod._buckets[key]
        bexec = bucket._exec_group.execs[0]
        for name in default._param_names:
            assert bexec.arg_dict[name] is dexec.arg_dict[name], name
            assert bexec.grad_dict[name] is dexec.grad_dict[name], name
            assert bexec.arg_dict[name].handle.data_ptr() == \
                dexec.arg_dict[name].handle.data_ptr()
        for name in ('data', 'softmax_label'):
            assert bexec.arg_dict[name].shape == (N, key)
        assert bucket._fused_opt_state is default._fused_opt_state
        assert bucket._optimizer is default._optimizer
        assert bucket._arg_params is default._arg_params
    # one update count for every bucket: three steps of the shared optimizer
    assert default._optimizer.num_update == 3


def _bound_at_first_batch(pkg, lm, arg):
    """{bucket key: has its fused step} at the end of a fit's first
    batch, over the BucketSentenceIter of :func:`_iterator`, with buckets
    8 and 12 declared."""
    seen = {}
    mod = pkg.mod.BucketingModule(lm.sym_gen_bucketing(**CFG),
                                  default_bucket_key=MAX_T,
                                  context=pkg.cpu(), bucket_keys=[8, 12])

    def first_batch(params):
        if params.nbatch == 0:
            seen.update({k: getattr(m, '_fused', None) is not None
                         for k, m in mod._buckets.items()})

    mod.fit(_iterator(pkg), num_epoch=1, optimizer='sgd',
            optimizer_params=OPT,
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
            batch_end_callback=first_batch)
    return seen


def test_precompile_buckets_binds_declared_buckets_at_fit_start(
        arg, monkeypatch):
    """Under MXTPU_PRECOMPILE_BUCKETS every declared bucket is bound (as
    in the JAX package) and has its fused step before the first batch;
    without it only the buckets seen so far are bound."""
    assert len(_bound_at_first_batch(tmx, tlm, arg)) < 3
    monkeypatch.setenv('MXTPU_PRECOMPILE_BUCKETS', '1')
    got = _bound_at_first_batch(tmx, tlm, arg)
    want = _bound_at_first_batch(mx, jlm, arg)
    assert sorted(got) == sorted(want) == [8, 12, 16]
    assert all(got.values())


def test_fit_warm_start_builds_the_fused_step_before_the_first_batch(arg):
    mod = _module(tmx, tlm, arg)
    default = mod._buckets[MAX_T]
    assert default._fused is None
    metric = tmx.metric.create('acc')
    compile_cache.warm_start(mod, metric)
    built = default._fused
    assert built is not None
    assert built.kernels == ['flash_attention', 'fused_dot_epilogue']
    t, toks, labels = _batches()[0]
    mod._fit_step(_batch(tmx, t, toks, labels), metric)
    assert default._fused is built


def _sentences():
    rng = np.random.RandomState(5)
    return [list(rng.randint(0, V, rng.randint(3, 17)))
            for _ in range(40)]


def _iterator(pkg):
    random.seed(7)
    np.random.seed(7)
    it_mod = pkg.rnn if pkg is tmx else mx.rnn
    return it_mod.BucketSentenceIter(_sentences(), N, buckets=[8, 12, 16])


def test_bucket_sentence_iter_matches_jax():
    coded, vocab = tmx.rnn.encode_sentences([['a', 'b'], ['b', 'c', 'a']])
    assert (coded, vocab) == mx.rnn.encode_sentences(
        [['a', 'b'], ['b', 'c', 'a']])
    tit, jit_ = _iterator(tmx), _iterator(mx)
    assert tit.provide_data == jit_.provide_data
    assert tit.provide_label == jit_.provide_label
    got = list(tit)
    want = list(jit_)
    assert len(got) == len(want) > 3
    assert {b.bucket_key for b in got} == {8, 12, 16}
    for tb, jb in zip(got, want):
        assert tb.bucket_key == jb.bucket_key
        assert tb.provide_data == jb.provide_data
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
    assert any((b.label[0].asnumpy() == -1).any() for b in got)


def test_fit_through_the_iterator_matches_jax(arg):
    """``fit`` over a BucketSentenceIter (padding -1) in both packages,
    with warm start on."""
    mods = []
    for pkg, lm in ((tmx, tlm), (mx, jlm)):
        it = _iterator(pkg)
        mod = pkg.mod.BucketingModule(lm.sym_gen_bucketing(**CFG),
                                      default_bucket_key=MAX_T,
                                      context=pkg.cpu())
        mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=OPT,
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
                warm_start=True)
        mods.append(mod)
    tp, jp = _params(mods[0]), _params(mods[1])
    moved = 0.0
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved = max(moved, float(np.max(np.abs(tp[k] - arg[k]))))
    assert moved > 1e-4


def _fc_gen(pkg):
    """A bucketed graph whose data is a float input: every bucket shares
    the one (3, 1) weight."""
    def sym_gen(key):
        data = pkg.sym.Variable('data')
        flat = pkg.sym.Reshape(data, shape=(-1, 1), name='flat')
        fc = pkg.sym.FullyConnected(flat, num_hidden=3, name='fc')
        label = pkg.sym.Reshape(pkg.sym.Variable('softmax_label'),
                                shape=(-1,), name='flat_label')
        return (pkg.sym.SoftmaxOutput(fc, label, name='softmax'),
                ('data',), ('softmax_label',))
    return sym_gen


@pytest.mark.parametrize('method', ['get_input_grads', 'install_monitor'])
def test_unported_bucketing_methods_raise(arg, method):
    """Both methods match the JAX package: ``get_input_grads`` gives the
    current bucket's data gradient (bound with ``inputs_need_grad``) over
    alternating buckets, and ``install_monitor`` taps the bound buckets
    (tests/test_torch_monitor.py covers the taps).  The mesh, which
    raised here until it was ported, installs one plan on every bucket,
    whose sig equals the JAX package's (tests/test_torch_mesh.py trains a
    BucketingModule on ranks)."""
    r = np.random.RandomState(6)
    weight = r.randn(3, 1).astype(np.float32)
    got = {}
    for pkg in (tmx, mx):
        mod = pkg.mod.BucketingModule(_fc_gen(pkg), default_bucket_key=6,
                                      context=pkg.cpu())
        mod.bind([('data', (2, 6))], [('softmax_label', (2, 6))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={'fc_weight': pkg.nd.array(weight),
                                    'fc_bias': pkg.nd.zeros((3,))})
        mod.init_optimizer(optimizer_params=OPT)
        if method == 'install_monitor':
            # the reference taps only the buckets bound at the call
            mod.switch_bucket(4, [('data', (2, 4))],
                              [('softmax_label', (2, 4))])
            mon = pkg.monitor.Monitor(1, pattern='fc.*')
            mod.install_monitor(mon)
        out = []
        for step, key in enumerate((6, 4, 6)):
            rs = np.random.RandomState(step)
            batch = pkg.io.DataBatch(
                [pkg.nd.array(rs.randn(2, key).astype(np.float32))],
                [pkg.nd.array(rs.randint(0, 3, (2, key)).astype(
                    np.float32))], bucket_key=key,
                provide_data=[('data', (2, key))],
                provide_label=[('softmax_label', (2, key))])
            if method == 'install_monitor':
                mon.tic()
            mod.forward_backward(batch)
            mod.update()
            if method == 'install_monitor':
                out.append([(n, v) for _, n, v in mon.toc()])
            else:
                out.append(mod.get_input_grads()[0].asnumpy())
        got[pkg] = out
    for t, j in zip(got[tmx], got[mx]):
        if method == 'install_monitor':
            # the tap, then the output of each tapped executor that ran
            assert [n for n, _ in t] == [n for n, _ in j]
            assert [n for n, _ in t][:2] == ['fc_output', 'softmax_output']
            np.testing.assert_allclose(
                [float(v) for _, v in t], [float(v) for _, v in j],
                rtol=1e-5)
        else:
            assert t.shape == j.shape
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    mod = _module(tmx, tlm, arg)
    mod._set_parallel('1x1', 'auto')
    jmod = _module(mx, jlm, arg)
    jmod._set_parallel('1x1', 'auto')
    assert mod._buckets and all(m._mesh_plan is mod._mesh_plan
                                for m in mod._buckets.values())
    assert mod._mesh_plan.sig() == \
        next(iter(jmod._buckets.values()))._mesh_plan.sig()


# ---------------------------------------------------------------------------
# The repairs: Embedding ids, SoftmaxOutput labels, bf16 token ids
# ---------------------------------------------------------------------------

def _op(reg, name):
    return reg.get_op(name).apply


def test_embedding_reads_ids_as_jnp_take():
    """Ids -1 (wraps to V-1), 0, V-1, V and -V-1 (NaN rows, no gradient)
    and fractional ids (truncated): forward and weight gradient."""
    vocab, dim = 4, 3
    w = np.arange(vocab * dim, dtype=np.float32).reshape(vocab, dim)
    ids = np.array([[-1, 0, vocab - 1], [vocab, -vocab - 1, 2.7],
                    [-0.5, -1.5, 1.2]], np.float32)
    cot = np.random.RandomState(0).standard_normal(
        ids.shape + (dim,)).astype(np.float32)
    attrs = {'input_dim': vocab, 'output_dim': dim}

    def jax_fn(wj):
        out = _op(jreg, 'Embedding')(attrs, [jnp.asarray(ids), wj], True,
                                     None)[0][0]
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out * cot)), out

    (_, jout), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    tout = _op(treg, 'Embedding')(attrs, [torch.from_numpy(ids), wt], True,
                                  None)[0][0]
    torch.where(torch.isnan(tout), 0.0, tout * torch.from_numpy(cot)) \
        .sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    assert np.isnan(np.asarray(jout)[1, :2]).all()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize('normalization', ['null', 'batch', 'valid'])
@pytest.mark.parametrize('use_ignore', [False, True],
                         ids=['no_ignore', 'ignore'])
@pytest.mark.parametrize('multi', [False, True], ids=['rows', 'multi'])
def test_softmax_output_labels_outside_the_classes(normalization,
                                                   use_ignore, multi):
    """Labels -1 and C give a zero one-hot row, as jax.nn.one_hot does;
    with use_ignore the -1 row's gradient is masked too."""
    classes = 5
    rng = np.random.RandomState(2)
    if multi:
        data = rng.standard_normal((3, classes, 2)).astype(np.float32)
        label = np.array([[1, -1], [classes, 2], [0, 4]], np.float32)
    else:
        data = rng.standard_normal((4, classes)).astype(np.float32)
        label = np.array([1, -1, classes, 2], np.float32)
    attrs = {'use_ignore': use_ignore, 'ignore_label': -1,
             'normalization': normalization, 'multi_output': multi}

    def jax_fn(d):
        out = _op(jreg, 'SoftmaxOutput')(jreg.get_op('SoftmaxOutput')
                                          .canon_attrs(attrs),
                                          [d, jnp.asarray(label)], True,
                                          None)[0][0]
        return jnp.sum(out), out

    (_, jout), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(data))
    dt = torch.from_numpy(data).requires_grad_(True)
    tout = _op(treg, 'SoftmaxOutput')(
        treg.get_op('SoftmaxOutput').canon_attrs(attrs),
        [dt, torch.from_numpy(label)], True, None)[0][0]
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)


def test_cross_entropy_device_form_reads_labels_as_jax():
    """The fused step's metric fold: label -1 wraps to the last class,
    a label outside [-C, C) gives NaN, as jnp.take_along_axis does."""
    probs = np.random.RandomState(3).dirichlet(np.ones(5), 4) \
        .astype(np.float32)
    for label in (np.array([1, -1, 4, 0], np.float32),
                  np.array([1, 5, 0, -6], np.float32)):
        ts, tn = tmetric.CrossEntropy().device_update(
            torch.from_numpy(label), torch.from_numpy(probs))
        js, jn = jmetric.CrossEntropy().device_update(
            jnp.asarray(label), jnp.asarray(probs))
        assert tn == int(jn)
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def test_bf16_module_keeps_token_ids_exact():
    """One bf16 Module step on ids in [0, 1000): the rows of
    embed_weight with a gradient are exactly the ids of the batch (bf16
    would round ids above 256 onto other rows)."""
    vocab, t = 1000, 8
    sym = tmx.models.get_symbol('transformer_lm', vocab_size=vocab,
                                num_embed=E, num_heads=HEADS,
                                num_layers=LAYERS, seq_len=t)
    toks = np.random.RandomState(4).randint(0, vocab, (N, t)) \
        .astype(np.float32)
    assert (toks > 256).sum() > N * t // 2
    mod = tmx.mod.Module(sym, context=tmx.cpu(),
                         compute_dtype=torch.bfloat16)
    mod.bind(data_shapes=[('data', (N, t))],
             label_shapes=[('softmax_label', (N, t))])
    mod.init_params(tmx.init.Normal(0.02))
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1})
    before = mod.get_params()[0]['tok_embed_weight'].asnumpy().copy()
    mod._fit_step(tmx.io.DataBatch([tmx.nd.array(toks)],
                                   [tmx.nd.array((toks + 1) % vocab)]))
    after = mod.get_params()[0]['tok_embed_weight'].asnumpy()
    moved = np.flatnonzero(np.abs(after - before).sum(axis=1))
    np.testing.assert_array_equal(moved, np.unique(toks.astype(int)))
    assert tmx.parallel.train_step.index_inputs(sym) == {'data'}
