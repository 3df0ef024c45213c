"""The four port faults of ROADMAP Queue 3 (items 1-4), each repaired and
held against the JAX package on the CPU with the same numpy inputs.

1. ``pick`` (both ``keepdims``), ``choose_element_0index`` and
   ``batch_take`` take a negative index as ``jnp.take_along_axis`` does:
   one in [-size, 0) counts from the end, one past either end reads NaN
   (the fill; the port gathers a clamped index, so the card sees no
   out-of-range one).
2. ``sort``/``argsort`` with ``axis=None`` sort the flattened array.
3. ``slice_axis`` clamps as Python slicing does.
4. The public names the port lacked: ``sym.zeros``/``ones``, top-level
   ``AttrScope``, ``base.Prefix``, ``mod.BatchEndParam``,
   ``io.DataDesc``, ``config.describe``/``list_knobs``,
   ``context.num_devices`` and ``BucketingModule.output_shapes``.

Tolerance: exact (NaN where the JAX op gives NaN)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg


def _both(op, attrs, inputs):
    """``op`` of each package's registry on the same numpy inputs."""
    j = jreg.get_op(op).apply(dict(attrs), [jnp.asarray(a) for a in inputs],
                              False, None)[0][0]
    t = treg.get_op(op).apply(dict(attrs), [torch.from_numpy(a.copy())
                                            for a in inputs], False, None)[0][0]
    return np.asarray(t.numpy()), np.asarray(j)


X = np.arange(24, dtype=np.float32).reshape(4, 6)
# -1 (the last column), -size-1 and size (past either end), in range
INDEX = np.array([-1, -7, 6, 2], np.float32)


@pytest.mark.parametrize('op,attrs', [
    ('pick', {'axis': 1}), ('pick', {'axis': 1, 'keepdims': True}),
    ('pick', {'axis': -1}), ('choose_element_0index', {}),
    ('batch_take', {})])
@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_negative_and_out_of_range_index_takes_the_jax_fill(op, attrs, dtype):
    got, want = _both(op, attrs, [X.astype(dtype), INDEX])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if dtype == np.float32:
        assert np.isnan(got.ravel()[1:3]).all() and got.ravel()[0] == 5


def test_pick_along_axis_0_and_through_nd():
    idx = np.array([[-1, 4, -5, 0, 3, -4]], np.float32)
    got, want = _both('pick', {'axis': 0, 'keepdims': True}, [X, idx[0]])
    np.testing.assert_array_equal(got, want)
    with tmx.cpu():
        t = tmx.nd.pick(tmx.nd.array(X), tmx.nd.array(INDEX), axis=1)
    j = mx.nd.pick(mx.nd.array(X), mx.nd.array(INDEX), axis=1)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize('op', ['sort', 'argsort'])
@pytest.mark.parametrize('is_ascend', [True, False])
def test_sort_with_axis_none_sorts_the_flattened_array(op, is_ascend):
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    x[1, 2] = x[0, 4]                   # a tie: the stable order
    got, want = _both(op, {'axis': None, 'is_ascend': is_ascend}, [x])
    assert got.shape == want.shape == (15,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('begin,end,shape', [
    (2, 10, (4, 4)), (4, 2, (4, 0)), (-3, None, (4, 3)), (1, -1, (4, 4)),
    (-10, 3, (4, 1)), (7, 9, (4, 0))])
def test_slice_axis_clamps_as_python_slicing(begin, end, shape):
    got, want = _both('slice_axis', {'axis': 1, 'begin': begin, 'end': end},
                      [X])
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_symbol_zeros_ones_match_jax():
    for name in ('zeros', 'ones'):
        t = getattr(tmx.sym, name)(shape=(2, 3), name='z')
        j = getattr(mx.sym, name)(shape=(2, 3), name='z')
        assert t.list_outputs() == j.list_outputs()
        assert t.infer_shape()[1] == j.infer_shape()[1]


def test_attr_scope_prefix_and_batch_end_param():
    assert tmx.AttrScope is tmx.base.AttrScope
    with tmx.AttrScope(ctx_group='stage1'):
        t = tmx.sym.Variable('a')
    with mx.AttrScope(ctx_group='stage1'):
        j = mx.sym.Variable('a')
    assert t.attr('ctx_group') == j.attr('ctx_group') == 'stage1'
    tp, jp = tmx.base.Prefix('net_'), mx.base.Prefix('net_')
    assert [tp.get(None, 'fc') for _ in range(2)] == \
        [jp.get(None, 'fc') for _ in range(2)] == ['net_fc0', 'net_fc1']
    assert tp.get('given', 'fc') == jp.get('given', 'fc')
    assert tmx.mod.BatchEndParam._fields == mx.mod.BatchEndParam._fields
    p = tmx.mod.BatchEndParam(epoch=1, nbatch=2, eval_metric=None,
                              locals=None)
    assert (p.epoch, p.nbatch) == (1, 2)


def test_data_desc_and_num_devices(monkeypatch):
    import jax
    assert tmx.io.DataDesc._fields == mx.io.DataDesc._fields
    assert tmx.io.DataDesc('data', (2, 3)) == ('data', (2, 3))
    # each counts its platform's devices: the JAX package its backend's
    # (the virtual CPU devices of the test run here), the port the CUDA
    # devices, else the host's one
    assert mx.context.num_devices() == len(jax.devices())
    assert tmx.context.num_devices() == 1
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert tmx.context.num_devices() == 4


def test_config_describe_and_list_knobs():
    from mxnet_tpu import config as jconfig
    knobs = tmx.config.list_knobs()
    assert knobs == sorted(tmx.config._REGISTRY) and len(knobs) > 50
    text = tmx.config.describe()
    jtext = jconfig.describe()
    for name in knobs:
        assert '\n%s (default ' % name in '\n' + text
    # a knob both packages register with the same default reads alike
    shared = [n for n in knobs if n in jconfig._REGISTRY
              and jconfig._REGISTRY[n].effective
              and jconfig._REGISTRY[n].doc_default is None
              and jconfig._REGISTRY[n].default ==
              tmx.config._REGISTRY[n].default]
    assert len(shared) > 10
    for name in shared:
        head = '%s (default %r)' % (name, tmx.config._REGISTRY[name].default)
        assert head in text and head in jtext


def test_bucketing_module_output_shapes():
    def gen(pkg):
        def sym_gen(key):
            data = pkg.sym.Variable('data')
            fc = pkg.sym.FullyConnected(data, num_hidden=3, name='fc')
            return pkg.sym.SoftmaxOutput(fc, name='softmax'), ('data',), \
                ('softmax_label',)
        return sym_gen
    shapes = [('data', (4, 5))], [('softmax_label', (4,))]
    t = tmx.mod.BucketingModule(gen(tmx), default_bucket_key=5,
                                context=tmx.cpu())
    j = mx.mod.BucketingModule(gen(mx), default_bucket_key=5,
                               context=mx.cpu())
    t.bind(*shapes)
    j.bind(*shapes)
    assert [(n, tuple(s)) for n, s in t.output_shapes] == \
        [(n, tuple(s)) for n, s in j.output_shapes] == \
        [('softmax_output', (4, 3))]
