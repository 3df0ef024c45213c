"""The port's new metrics and initializers, and its mlp/lenet symbols,
against the JAX package's on the CPU.

Metrics: the host ``update`` against the JAX metric on the same random
labels and predictions, and the device fold (what the fused step adds
into its accumulator) against the host path; rtol 1e-6 for host parity,
1e-5 for the fold (float32 sums on the device against numpy's float64).
Initializers: ``Orthogonal`` and ``Bilinear`` exact (numpy draws under one
``np.random.seed``), ``MSRAPrelu`` by the scale of its draws."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx


def _classification(seed, classes=6, rows=(5, 7, 4)):
    r = np.random.RandomState(seed)
    preds = [r.dirichlet(np.ones(classes), size=n).astype(np.float32)
             for n in rows]
    labels = [r.randint(0, classes, n).astype(np.float32) for n in rows]
    return labels, preds


def _regression(seed):
    r = np.random.RandomState(seed)
    labels = [r.randn(n).astype(np.float32) for n in (6, 3)]
    preds = [r.randn(n, 1).astype(np.float32) for n in (6, 3)]
    return labels, preds


def _binary(seed):
    r = np.random.RandomState(seed)
    preds = [r.dirichlet(np.ones(2), size=n).astype(np.float32)
             for n in (9, 12)]
    labels = [r.randint(0, 2, n).astype(np.float32) for n in (9, 12)]
    return labels, preds


def _lm(seed, ignore):
    """(rows, T) token labels against (rows * T, V) probabilities, some
    labels equal to the ignored id."""
    r = np.random.RandomState(seed)
    labels = [r.randint(0, 9, (3, 4)).astype(np.float32) for _ in range(2)]
    if ignore is not None:
        labels[0][0, :2] = ignore
    preds = [r.dirichlet(np.ones(9), size=12).astype(np.float32)
             for _ in range(2)]
    return labels, preds


METRICS = [
    ('perplexity', {'ignore_label': None}, lambda: _lm(0, None)),
    ('perplexity', {'ignore_label': 0}, lambda: _lm(1, 0)),
    ('perplexity', {'ignore_label': -1}, lambda: _lm(2, -1)),
    ('mae', {}, lambda: _regression(3)),
    ('mse', {}, lambda: _regression(4)),
    ('rmse', {}, lambda: _regression(5)),
    ('f1', {}, lambda: _binary(6)),
]


@pytest.mark.parametrize('name,kw,make', METRICS,
                         ids=['%s-%d' % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_matches_jax_host_and_device(name, kw, make):
    labels, preds = make()
    jm, tm, dm = (mx.metric.create(name, **kw), tmx.metric.create(name, **kw),
                  tmx.metric.create(name, **kw))
    for lab, p in zip(labels, preds):
        jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
        tm.update([tmx.nd.array(lab)], [tmx.nd.array(p)])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert tm.num_inst == jm.num_inst
    if name == 'f1':
        assert not dm.device_capable()
        return
    assert dm.device_capable()
    for lab, p in zip(labels, preds):
        dm.device_fold(torch.from_numpy(lab), torch.from_numpy(p))
    before = tmx.instrument.counter_value('metric.host_syncs')
    dn, dv = dm.get()
    assert dn == tn and dm.num_inst == tm.num_inst
    assert tmx.instrument.counter_value('metric.host_syncs') == before + 1
    np.testing.assert_allclose(dv, tv, rtol=1e-5)


def test_perplexity_device_fold_keeps_the_data_dependent_count():
    """With ignored labels the instance count is data: it rides in the
    device accumulator (a second slot), and a composite with another
    metric drains both in one host sync."""
    labels, preds = _lm(7, 3)
    comp = tmx.metric.create([tmx.metric.Perplexity(ignore_label=3), 'acc'])
    ref = mx.metric.create([mx.metric.Perplexity(ignore_label=3), 'acc'])
    flat = [lab.reshape(-1) for lab in labels]
    for lab, f, p in zip(labels, flat, preds):
        comp.metrics[0].device_fold(torch.from_numpy(lab),
                                    torch.from_numpy(p))
        comp.metrics[1].device_fold(torch.from_numpy(f), torch.from_numpy(p))
        ref.metrics[0].update([mx.nd.array(lab)], [mx.nd.array(p)])
        ref.metrics[1].update([mx.nd.array(f)], [mx.nd.array(p)])
    before = tmx.instrument.counter_value('metric.host_syncs')
    names, values = comp.get()
    assert tmx.instrument.counter_value('metric.host_syncs') == before + 1
    rnames, rvalues = ref.get()
    assert names == rnames
    np.testing.assert_allclose(values, rvalues, rtol=1e-5)
    assert comp.metrics[0].num_inst == ref.metrics[0].num_inst
    comp.reset()
    assert comp.metrics[0].num_inst == 0 and \
        float(comp.metrics[0]._dev_sum.abs().sum()) == 0.0


def test_device_fold_keys_match_the_reference_shape():
    for pkg in (mx, tmx):
        a = pkg.metric.Perplexity(ignore_label=0)
        b = pkg.metric.Perplexity(ignore_label=0)
        c = pkg.metric.Perplexity(ignore_label=None)
        assert a.device_fold_key() == b.device_fold_key() != \
            c.device_fold_key()
        assert pkg.metric.create('mse').device_fold_key() != \
            pkg.metric.create('mae').device_fold_key()
    assert tmx.metric.create('top_k_accuracy', top_k=3).device_fold_key()[
        -1] == 3


def test_custom_metric_and_np_match_jax():
    labels, preds = _classification(8)

    def hits(label, pred):
        return float((pred.argmax(axis=1) == label).sum()), len(label)

    def mean_top(label, pred):
        return float(pred.max(axis=1).mean())

    for make in (lambda pkg: pkg.metric.CustomMetric(hits, name='hits'),
                 lambda pkg: pkg.metric.np(mean_top),
                 lambda pkg: pkg.metric.create(mean_top)):
        jm, tm = make(mx), make(tmx)
        for lab, p in zip(labels, preds):
            jm.update([mx.nd.array(lab)], [mx.nd.array(p)])
            tm.update([tmx.nd.array(lab)], [tmx.nd.array(p)])
        assert tm.get()[0] == jm.get()[0]
        np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
        assert not tm.device_capable()


def test_metric_create_knows_every_name():
    for name in ('acc', 'accuracy', 'ce', 'f1', 'mae', 'mse', 'rmse',
                 'perplexity'):
        kw = {'ignore_label': None} if name == 'perplexity' else {}
        assert tmx.metric.create(name, **kw).name == \
            mx.metric.create(name, **kw).name
    with pytest.raises(ValueError):
        tmx.metric.create('nope')


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,kw', [((6, 4), {}), ((3, 2, 3, 3), {}),
                                      ((8, 5), {'rand_type': 'normal',
                                                'scale': 0.5})])
def test_orthogonal_matches_jax_exactly(shape, kw):
    got = {}
    for pkg in (mx, tmx):
        np.random.seed(11)
        arr = pkg.nd.zeros(shape)
        pkg.init.Orthogonal(**kw)(pkg.init.InitDesc('fc_weight'), arr)
        got[pkg] = arr.asnumpy()
    np.testing.assert_array_equal(got[tmx], got[mx])
    flat = got[tmx].reshape(shape[0], -1)
    scale = kw.get('scale', 1.414)
    gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
    np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                               atol=1e-5)


def test_bilinear_matches_jax_exactly():
    got = {}
    for pkg in (mx, tmx):
        w, up = pkg.nd.zeros((2, 1, 4, 4)), pkg.nd.zeros((1, 1, 3, 5))
        pkg.init.Bilinear()(pkg.init.InitDesc('deconv_weight'), w)
        # any initializer gives an upsampling* weight the bilinear kernel
        pkg.init.Uniform()(pkg.init.InitDesc('upsampling0_weight'), up)
        got[pkg] = (w.asnumpy(), up.asnumpy())
    for a, b in zip(got[tmx], got[mx]):
        np.testing.assert_array_equal(a, b)
    assert got[tmx][0][0, 0, 1, 1] == 0.5625


def test_msraprelu_scale():
    """Gaussian Xavier of magnitude 2 / (1 + slope^2): the std of the
    draws against sqrt(magnitude / fan)."""
    tmx.random.seed(5)
    arr = tmx.nd.zeros((256, 128, 3, 3))
    init = tmx.init.MSRAPrelu(factor_type='in', slope=0.25)
    init(tmx.init.InitDesc('conv_weight'), arr)
    w = arr.asnumpy()
    want = np.sqrt(2. / (1 + 0.25 ** 2) / (128 * 9))
    assert abs(w.std() / want - 1) < 0.01 and abs(w.mean()) < want * 0.01
    assert init.rnd_type == mx.init.MSRAPrelu().rnd_type == 'gaussian'
    assert init.magnitude == mx.init.MSRAPrelu(slope=0.25).magnitude


def test_initializer_registry_creates_new_names():
    assert isinstance(tmx.init.create('orthogonal'), tmx.init.Orthogonal)
    assert isinstance(tmx.init.create('bilinear'), tmx.init.Bilinear)
    back = tmx.init.create(tmx.init.Orthogonal(scale=2.0).dumps())
    assert back.scale == 2.0


# ---------------------------------------------------------------------------
# symbol builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,kw', [('mlp', {}), ('mlp', {'hidden': (7,),
                                                           'num_classes': 3}),
                                     ('lenet', {}),
                                     ('lenet', {'num_classes': 4})])
def test_model_symbol_json_matches_jax(name, kw):
    from mxnet_tpu import models as jmodels
    # fresh automatic names (activation0, ...) in both packages
    with tmx.base.NameManager():
        tsym = tmx.models.get_symbol(name, **kw)
    with mx.base.NameManager():
        jsym = jmodels.get_symbol(name, **kw)
    assert tsym.tojson() == jsym.tojson()
    shape = (2, 784) if name == 'mlp' else (2, 1, 28, 28)
    assert tsym.infer_shape(data=shape)[1] == jsym.infer_shape(
        data=shape)[1]
