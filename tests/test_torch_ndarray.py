"""The imperative ``nd.*`` layer of the PyTorch port against the JAX
package's, on the CPU (mirrors tests/test_ndarray.py and
tests/test_random.py).

One parametrised case per tensor op (mxnet_tpu/ops/tensor.py) and per
imperative nn op: the same numpy inputs through ``mxnet_tpu.nd.<op>``
and ``mxnet_tpu_torch.nd.<op>``.  Tolerances: exact for integer,
indexing, ordering and comparison ops and for ops that only move data;
rtol 1e-6, atol 1e-7 for float32 math (the two frameworks' CPU
transcendentals round differently in the last bits).  The samplers draw
from different generators in the two packages, so they are compared by
moments only."""
import os
import pickle
import tempfile
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

R = np.random.RandomState(7)


@pytest.fixture(autouse=True)
def _on_the_host():
    """Every test here asks for the CPU: outside a ``with`` scope the
    port's ``nd.ones`` / ``nd.arange`` / samplers / no-input ops run on
    the card."""
    with tmx.cpu():
        yield


def _n(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _pos(*shape):
    return (R.rand(*shape) + 0.5).astype(np.float32)


def _unit(*shape):
    return (R.rand(*shape) * 1.8 - 0.9).astype(np.float32)


def _ints(*shape, hi=4):
    """Integer-valued float32 (ties, exact comparisons)."""
    return R.randint(-hi, hi, shape).astype(np.float32)


def _idx(n, *shape):
    return R.randint(0, n, shape).astype(np.float32)


X = (3, 4)
# op -> (inputs factory, attrs, exact)
CASES = {}
for _op in ('negative', 'abs', 'sign', 'ceil', 'floor', 'fix', 'square',
            'exp', 'expm1', 'sin', 'cos', 'tan', 'arctan', 'sinh', 'cosh',
            'tanh', 'arcsinh', 'degrees', 'radians', 'sigmoid', 'relu',
            'softsign', 'trunc'):
    CASES[_op] = (lambda: [_n(*X)], {}, _op in (
        'negative', 'abs', 'sign', 'ceil', 'floor', 'fix', 'relu', 'trunc'))
for _op in ('sqrt', 'rsqrt', 'cbrt', 'rcbrt', 'log', 'log10', 'log2',
            'log1p', 'gamma', 'gammaln', 'reciprocal'):
    CASES[_op] = (lambda: [_pos(*X) * 3], {}, False)
for _op in ('arcsin', 'arccos', 'arctanh'):
    CASES[_op] = (lambda: [_unit(*X)], {}, False)
CASES['arccosh'] = (lambda: [_pos(*X) + 1.0], {}, False)
CASES['round'] = (lambda: [np.array([[-2.5, -1.5, -0.5, 0.5],
                                     [1.5, 2.5, 0.4, -0.6]], np.float32)],
                  {}, True)
CASES['rint'] = CASES['round']
CASES['logical_not'] = (lambda: [_ints(*X, hi=2)], {}, True)
CASES['identity'] = (lambda: [_n(*X)], {}, True)
CASES['stop_gradient'] = (lambda: [_n(*X)], {}, True)
CASES['make_loss'] = (lambda: [_n(*X)], {'grad_scale': 2.0}, True)
CASES['_identity_with_attr_like_rhs'] = (lambda: [_n(*X), _n(*X)], {}, True)
CASES['_CrossDeviceCopy'] = (lambda: [_n(*X)], {}, True)
CASES['clip'] = (lambda: [_n(*X)], {'a_min': -0.5, 'a_max': 0.7}, True)
CASES['Cast'] = (lambda: [_n(*X) * 10], {'dtype': 'int32'}, True)
for _op in ('_plus', '_minus', '_mul', '_div', '_maximum', '_minimum',
            '_hypot'):
    CASES[_op] = (lambda: [_n(*X), _n(*X)], {}, _op in (
        '_plus', '_minus', '_mul', '_maximum', '_minimum'))
CASES['_mod'] = (lambda: [_n(*X) * 5, np.where(R.rand(*X) > 0.5, 1, -1)
                          .astype(np.float32) * _pos(*X)], {}, False)
CASES['_power'] = (lambda: [_pos(*X), _n(*X)], {}, False)
for _op in ('_equal', '_not_equal', '_greater', '_greater_equal', '_lesser',
            '_lesser_equal'):
    CASES[_op] = (lambda: [_ints(*X), _ints(*X)], {}, True)
for _op, _sc in (('_plus_scalar', 1.5), ('_minus_scalar', 1.5),
                 ('_rminus_scalar', 1.5), ('_mul_scalar', -2.0),
                 ('_div_scalar', 4.0), ('_rdiv_scalar', 3.0),
                 ('_mod_scalar', -1.5), ('_rmod_scalar', 2.5),
                 ('_power_scalar', 2.0), ('_rpower_scalar', 1.7),
                 ('_maximum_scalar', 0.25), ('_minimum_scalar', 0.25),
                 ('_hypot_scalar', 1.5), ('_equal_scalar', 1.0),
                 ('_not_equal_scalar', 1.0), ('_greater_scalar', 1.0),
                 ('_greater_equal_scalar', 1.0), ('_lesser_scalar', 1.0),
                 ('_lesser_equal_scalar', 1.0), ('smooth_l1', 0.7)):
    CASES[_op] = ((lambda: [_pos(*X) * 3]) if _op in ('_rdiv_scalar',
                                                       '_rmod_scalar')
                  else (lambda: [_ints(*X)]) if 'equal' in _op or
                  'greater' in _op or 'lesser' in _op
                  else (lambda: [_n(*X) * 2]), {'scalar': _sc},
                  _op in ('_plus_scalar', '_minus_scalar', '_rminus_scalar',
                          '_mul_scalar', '_div_scalar', '_maximum_scalar',
                          '_minimum_scalar') or 'equal' in _op or
                  'greater' in _op or 'lesser' in _op)
for _op in ('broadcast_add', 'broadcast_plus', 'broadcast_sub',
            'broadcast_minus', 'broadcast_mul', 'broadcast_div',
            'broadcast_maximum', 'broadcast_minimum', 'broadcast_hypot'):
    CASES[_op] = (lambda: [_n(2, 3, 4), _n(1, 3, 1)], {},
                  _op not in ('broadcast_div', 'broadcast_hypot'))
CASES['broadcast_mod'] = (lambda: [_n(2, 3, 4) * 5, _pos(1, 3, 1)], {},
                          False)
CASES['broadcast_power'] = (lambda: [_pos(2, 3, 4), _n(1, 3, 1)], {}, False)
for _op in ('broadcast_equal', 'broadcast_not_equal', 'broadcast_greater',
            'broadcast_greater_equal', 'broadcast_lesser',
            'broadcast_lesser_equal'):
    CASES[_op] = (lambda: [_ints(2, 3, 4), _ints(1, 3, 1)], {}, True)
CASES['broadcast_to'] = (lambda: [_n(2, 1, 3)], {'shape': (2, 4, 0)}, True)
CASES['broadcast_axis'] = (lambda: [_n(2, 1, 1)], {'axis': (1, 2),
                                                   'size': (3, 4)}, True)
for _op in ('sum', 'mean', 'prod', 'nansum', 'nanprod', 'max', 'min'):
    CASES[_op] = (lambda nan=_op.startswith('nan'): [
        np.where(R.rand(2, 3, 4) > 0.7, np.nan, _pos(2, 3, 4))
        .astype(np.float32) if nan else _n(2, 3, 4)],
                  {'axis': (0, 2), 'keepdims': True}, _op in ('max', 'min'))
CASES['sum_exclude'] = ('sum', lambda: [_n(2, 3, 4)],
                        {'axis': 1, 'exclude': True}, False)
CASES['sum_int'] = ('sum', lambda: [np.arange(12, dtype=np.int32)
                                    .reshape(3, 4)], {'axis': 0}, True)
CASES['prod_all'] = ('prod', lambda: [_pos(2, 3)], {}, False)
CASES['argmax'] = (lambda: [_ints(3, 5)], {'axis': 1}, True)
CASES['argmin'] = (lambda: [_ints(3, 5)], {'axis': 0, 'keepdims': True},
                   True)
CASES['argmax_flat'] = ('argmax', lambda: [_ints(3, 5)], {}, True)
CASES['argmax_channel'] = (lambda: [_ints(3, 5)], {}, True)
CASES['norm'] = (lambda: [_n(3, 5)], {}, False)
CASES['Reshape'] = (lambda: [_n(2, 3, 4)], {'shape': (-1, 0)}, True)
CASES['Flatten'] = (lambda: [_n(2, 3, 4)], {}, True)
CASES['transpose'] = (lambda: [_n(2, 3, 4)], {'axes': (1, 0, 2)}, True)
CASES['expand_dims'] = (lambda: [_n(2, 3)], {'axis': -1}, True)
CASES['dot'] = (lambda: [_n(3, 5), _n(4, 5)], {'transpose_b': True}, False)
CASES['dot_3d'] = ('dot', lambda: [_n(2, 3, 5), _n(5, 4)], {}, False)
CASES['dot_vec'] = ('dot', lambda: [_n(5), _n(5)], {}, False)
CASES['batch_dot'] = (lambda: [_n(2, 5, 3), _n(2, 5, 4)],
                      {'transpose_a': True}, False)
CASES['slice'] = (lambda: [_n(4, 5, 3)], {'begin': (1, None, 0),
                                          'end': (3, -1, 2)}, True)
CASES['_slice_assign'] = (lambda: [_n(4, 5), _n(2, 3)],
                          {'begin': (1, 2), 'end': (3, 5)}, True)
CASES['_crop_assign_scalar'] = (lambda: [_n(4, 5)], {
    'begin': (0, 1), 'end': (2, 3), 'scalar': 7.0}, True)
CASES['slice_axis'] = (lambda: [_n(4, 5)], {'axis': 1, 'begin': -3,
                                            'end': None}, True)
CASES['flip'] = (lambda: [_n(3, 4)], {'axis': 1}, True)
CASES['repeat'] = (lambda: [_n(2, 3)], {'repeats': 2, 'axis': 1}, True)
CASES['repeat_flat'] = ('repeat', lambda: [_n(2, 3)], {'repeats': 3}, True)
CASES['tile'] = (lambda: [_n(2, 3)], {'reps': (2, 1, 2)}, True)
CASES['pad'] = (lambda: [_n(1, 2, 3, 4)], {
    'pad_width': (0, 0, 0, 0, 1, 2, 2, 1), 'mode': 'constant',
    'constant_value': 1.5}, True)
CASES['pad_edge'] = ('pad', lambda: [_n(1, 2, 3, 4)], {
    'pad_width': (0, 0, 0, 0, 1, 2, 2, 1), 'mode': 'edge'}, True)
CASES['pad_reflect'] = ('pad', lambda: [_n(1, 2, 4, 5)], {
    'pad_width': (0, 0, 0, 0, 2, 1, 1, 3), 'mode': 'reflect'}, True)
CASES['SwapAxis'] = (lambda: [_n(2, 3, 4)], {'dim1': 0, 'dim2': 2}, True)
CASES['take'] = (lambda: [_n(5, 3), np.array([[0, 4], [-1, 7]], np.float32)],
                 {'axis': 0}, True)
CASES['take_wrap'] = ('take', lambda: [_n(5, 3), np.array([1, 6, -2],
                                                          np.float32)],
                      {'axis': 0, 'mode': 'wrap'}, True)
CASES['batch_take'] = (lambda: [_n(4, 5), _idx(5, 4)], {}, True)
CASES['one_hot'] = (lambda: [np.array([0, 2, -1, 5], np.float32)],
                    {'depth': 4, 'on_value': 3.0, 'off_value': -1.0}, True)
CASES['where'] = (lambda: [_ints(3, 4, hi=2), _n(3, 4), _n(3, 4)], {}, True)
CASES['_zeros'] = (lambda: [], {'shape': (2, 3)}, True)
CASES['_ones'] = (lambda: [], {'shape': (2, 3), 'dtype': 'int32'}, True)
CASES['_full'] = (lambda: [], {'shape': (2, 3), 'value': 2.5}, True)
CASES['_arange'] = (lambda: [], {'start': 1.0, 'stop': 9.0, 'step': 2.0,
                                 'repeat': 2}, True)
CASES['_arange_stop_only'] = ('_arange', lambda: [], {'start': 5.0}, True)
CASES['zeros_like'] = (lambda: [_n(2, 3)], {}, True)
CASES['ones_like'] = (lambda: [_n(2, 3)], {}, True)
CASES['topk'] = (lambda: [_ints(3, 6)], {'k': 3}, True)
CASES['topk_both_ascend'] = ('topk', lambda: [_ints(3, 6)], {
    'k': 2, 'axis': 0, 'ret_typ': 'both', 'is_ascend': True}, True)
CASES['topk_value'] = ('topk', lambda: [_ints(3, 6)],
                       {'k': 2, 'ret_typ': 'value'}, True)
CASES['sort'] = (lambda: [_ints(3, 6)], {'is_ascend': False}, True)
CASES['argsort'] = (lambda: [_ints(3, 6)], {'axis': 0}, True)
CASES['argsort_desc'] = ('argsort', lambda: [_ints(3, 6)],
                         {'is_ascend': False}, True)
CASES['add_n'] = (lambda: [_n(2, 3), _n(2, 3), _n(2, 3)], {}, False)
CASES['diag'] = (lambda: [_n(4, 4)], {'k': 1}, True)
CASES['diag_vec'] = ('diag', lambda: [_n(3)], {'k': -1}, True)
CASES['diag_3d'] = ('diag', lambda: [_n(2, 3, 3)], {'axis1': 1,
                                                    'axis2': 2}, True)
CASES['stack'] = (lambda: [_n(2, 3), _n(2, 3)], {'axis': 1}, True)
CASES['pick'] = (lambda: [_n(3, 4), _idx(4, 3)], {'axis': 1}, True)
CASES['choose_element_0index'] = (lambda: [_n(3, 4), _idx(4, 3)], {}, True)
CASES['fill_element_0index'] = (lambda: [_n(3, 4), _n(3), _idx(4, 3)], {},
                                True)
# the nn ops an imperative user calls first (mxnet_tpu/ops/nn.py)
CASES['softmax'] = (lambda: [_n(3, 5) * 3], {'axis': 0,
                                             'temperature': 2.0}, False)
CASES['log_softmax'] = (lambda: [_n(3, 5) * 3], {}, False)
CASES['SoftmaxActivation'] = (lambda: [_n(2, 3, 4)], {}, False)
CASES['SoftmaxActivation_channel'] = ('SoftmaxActivation',
                                      lambda: [_n(2, 3, 4)],
                                      {'mode': 'channel'}, False)
CASES['LeakyReLU'] = (lambda: [_n(3, 4)], {'slope': 0.1}, True)
CASES['LeakyReLU_elu'] = ('LeakyReLU', lambda: [_n(3, 4)],
                          {'act_type': 'elu', 'slope': 0.3}, False)
CASES['LeakyReLU_prelu'] = ('LeakyReLU', lambda: [_n(2, 3, 4), _n(3)],
                            {'act_type': 'prelu'}, True)
CASES['Dropout_p0'] = ('Dropout', lambda: [_n(3, 4)], {'p': 0.0}, True)
CASES['Concat'] = (lambda: [_n(2, 3), _n(2, 1), _n(2, 2)], {'dim': 1}, True)
CASES['concat'] = (lambda: [_n(2, 3), _n(1, 3)], {'dim': 0}, True)


# XLA's float32 lgamma is up to 2.5e-6 off (absolute; gamma = exp(lgamma)
# inherits it as a relative error) where torch's is within 1.2e-7 of the
# float64 value: these two are held to scipy's float64 value at the
# float32 tolerance, and to the JAX package within its own error
JAX_ERROR = {'gamma': dict(rtol=3e-6, atol=0.0),
             'gammaln': dict(rtol=0.0, atol=3e-6)}


def _float64_reference(op, a):
    from scipy import special
    fn = {'gamma': special.gamma, 'gammaln': special.gammaln}[op]
    return fn(a.astype(np.float64))


def _case(name):
    c = CASES[name]
    return c if len(c) == 4 else (name,) + c


def _outs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_matches_jax(name):
    op, make, attrs, exact = _case(name)
    arrays = make()
    jres = _outs(getattr(mx.nd, op)(*[mx.nd.array(a, dtype=a.dtype)
                                      for a in arrays], **attrs))
    tres = _outs(getattr(tmx.nd, op)(*[tmx.nd.array(a) for a in arrays],
                                     **attrs))
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert isinstance(t, tmx.nd.NDArray)
        tv, jv = t.asnumpy(), j.asnumpy()
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, (tv, jv)
        if exact:
            np.testing.assert_array_equal(tv, jv)
        elif op in JAX_ERROR:
            np.testing.assert_allclose(tv, _float64_reference(op, arrays[0]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tv, jv, **JAX_ERROR[op])
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def _jax_tensor_ops():
    names = list(jreg._REGISTRY)
    return names[:names.index('FullyConnected')]


def test_tensor_op_set_matches_jax():
    """Every op mxnet_tpu/ops/tensor.py registers (the block before the
    first nn op, tensor being the first family the JAX registry imports)
    and every alias of one is registered in the port."""
    jax_ops = set(_jax_tensor_ops())
    # nothing is left out: the exclusion list is empty
    excluded = set()
    assert jax_ops - excluded <= set(treg._REGISTRY)
    jax_aliases = {a for a, target in jreg._ALIASES.items()
                   if target in jax_ops}
    assert {a: treg._ALIASES[a] for a in jax_aliases} == \
        {a: jreg._ALIASES[a] for a in jax_aliases}


def test_every_tensor_op_has_a_parity_case():
    covered = {_case(n)[0] for n in CASES}
    assert set(_jax_tensor_ops()) - {'_random_uniform', '_random_normal'} \
        <= covered


def test_creation_matches_jax():
    for pkg in (tmx, mx):
        nd = pkg.nd
        assert nd.zeros((3, 4)).asnumpy().sum() == 0
        assert nd.ones((2, 2)).asnumpy().sum() == 4
        np.testing.assert_array_equal(nd.full((2, 2), 3.5).asnumpy(), 3.5)
        assert nd.array([[1, 2], [3, 4]]).asnumpy().dtype == np.float32
        np.testing.assert_array_equal(nd.arange(0, 10, 2).asnumpy(),
                                      [0, 2, 4, 6, 8])
        np.testing.assert_array_equal(nd.empty((2, 3)).asnumpy(), 0)
        assert nd.arange(0, 3, repeat=2).shape == (6,)
    assert tmx.nd.array(np.arange(3, dtype=np.int32)).dtype == torch.int32
    assert tmx.nd.zeros((2,)).context == tmx.cpu()


def test_arithmetic_and_comparisons_match_jax():
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    b = np.array([[2.0, 2.0], [2.0, 2.0]], np.float32)
    exprs = [lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
             lambda x, y: x / y, lambda x, y: x ** 2, lambda x, y: 2 + x,
             lambda x, y: 2 - x, lambda x, y: 2 / x, lambda x, y: -x,
             lambda x, y: abs(-x), lambda x, y: x % 1.5,
             lambda x, y: x * np.float32(0.5), lambda x, y: x == y,
             lambda x, y: x != 2, lambda x, y: x > y, lambda x, y: x >= 2,
             lambda x, y: x < y, lambda x, y: x <= 3.0,
             lambda x, y: x + np.ones((2, 2))]
    for f in exprs:
        tv = f(tmx.nd.array(a), tmx.nd.array(b)).asnumpy()
        jv = f(mx.nd.array(a), mx.nd.array(b)).asnumpy()
        assert tv.dtype == jv.dtype
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def test_inplace_ops_swap_the_handle():
    for pkg in (tmx, mx):
        a = pkg.nd.ones((2, 2))
        b = a
        a += 1
        np.testing.assert_array_equal(b.asnumpy(), 2)
        a *= 3
        np.testing.assert_array_equal(b.asnumpy(), 6)
        a /= 2
        np.testing.assert_array_equal(b.asnumpy(), 3)
        a -= 1
        np.testing.assert_array_equal(b.asnumpy(), 2)


def test_setitem_getitem_match_jax():
    res = {}
    for pkg in (tmx, mx):
        a = pkg.nd.zeros((4, 4))
        a[:] = 2.0
        a[1] = 5.0
        a[2, 1:3] = np.array([7.0, 8.0])
        a[np.array([3])] = -1.0
        row, block = a[1], a[1:3]
        picked = a[pkg.nd.array([0, 2], dtype='int32')]
        res[pkg] = [a.asnumpy(), row.asnumpy(), block.asnumpy(),
                    picked.asnumpy(), a[0, 1].asnumpy()]
        assert row.shape == (4,) and block.shape == (2, 4)
    for t, j in zip(res[tmx], res[mx]):
        np.testing.assert_array_equal(t, j)


def test_slices_are_copies_under_handle_semantics():
    """As in the JAX package: a slice taken before a write to its parent
    keeps its values, whatever writes the parent (x[k] = v, x[:] = v,
    +=, an op's out=, or an in-place update of the parent's tensor)."""
    x = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    rows, col, elem = x[0:2], x[:, 1], x[1]
    before = [v.asnumpy() for v in (rows, col, elem)]
    x[0] = 100.0
    x += 1
    tmx.nd.relu(x, out=x)
    x.handle.mul_(3)          # the fused step updates parameters in place
    for v, b in zip((rows, col, elem), before):
        np.testing.assert_array_equal(v.asnumpy(), b)
    jx = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    jrows = jx[0:2]
    jx[0] = 100.0
    np.testing.assert_array_equal(jrows.asnumpy(), before[0])


def test_positional_attrs_out_and_named_inputs():
    a = np.array([[-1.0, 2.0], [3.0, -4.0]], np.float32)
    for pkg in (tmx, mx):
        x = pkg.nd.array(a)
        np.testing.assert_array_equal(pkg.nd.clip(x, -0.5, 2.5).asnumpy(),
                                      np.clip(a, -0.5, 2.5))
        dst = pkg.nd.zeros((2, 2))
        assert pkg.nd.relu(x, out=dst) is dst
        np.testing.assert_array_equal(dst.asnumpy(), np.maximum(a, 0))
        np.testing.assert_array_equal(
            pkg.nd.broadcast_add(lhs=x, rhs=x).asnumpy(), 2 * a)
        np.testing.assert_array_equal(pkg.nd._plus(x, x).asnumpy(), 2 * a)
        for f, want in ((pkg.nd.maximum(x, 0.5), np.maximum(a, 0.5)),
                        (pkg.nd.minimum(1.0, x), np.minimum(a, 1.0)),
                        (pkg.nd.power(2.0, x), 2.0 ** a),
                        (pkg.nd.maximum(x, x * 2), np.maximum(a, 2 * a))):
            np.testing.assert_allclose(f.asnumpy(), want, rtol=1e-6)
        assert pkg.nd.maximum(2, 3) == 3
        with pytest.raises(pkg.MXNetError):
            pkg.nd.clip(x, 1, 2, 3)
    with pytest.raises(AttributeError):
        tmx.nd.no_such_op


def test_reshape_slice_broadcast_methods():
    for pkg in (tmx, mx):
        a = pkg.nd.arange(0, 24).reshape((2, 3, 4))
        assert a.shape == (2, 3, 4) and a.size == 24 and len(a) == 2
        assert pkg.nd.Reshape(a, shape=(6, 4)).shape == (6, 4)
        assert pkg.nd.slice_axis(a, axis=2, begin=1, end=3).shape == \
            (2, 3, 2)
        assert pkg.nd.Flatten(a).shape == (2, 12)
        assert a.slice(1, 2).shape == (1, 3, 4)
        assert pkg.nd.ones((2, 1, 3)).broadcast_to((2, 4, 3)).shape == \
            (2, 4, 3)
        assert a.T.shape == (4, 3, 2)
        assert pkg.nd.array([4.0]).asscalar() == 4.0
        np.testing.assert_array_equal(a.T.asnumpy(), a.asnumpy().T)


def test_copyto_astype_wait_pickle():
    a = tmx.nd.ones((2, 2))
    d = tmx.nd.zeros((2, 2))
    a.copyto(d)
    np.testing.assert_array_equal(d.asnumpy(), 1.0)
    assert a.as_in_context(tmx.cpu()) is a
    with pytest.raises(tmx.MXNetError):
        a.copyto(a)
    b = a.astype('float16')
    assert b.dtype == torch.float16 and a.dtype == torch.float32
    assert tmx.nd.zeros((2, 2), dtype='bfloat16').dtype == torch.bfloat16
    c = tmx.nd.dot(tmx.nd.ones((50, 50)), tmx.nd.ones((50, 50)))
    assert c.wait_to_read() is c
    tmx.nd.waitall()
    assert c.asnumpy()[0, 0] == 50.0
    e = pickle.loads(pickle.dumps(tmx.nd.array(np.arange(6.0))))
    np.testing.assert_array_equal(e.asnumpy(), np.arange(6.0))
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, 'nd.bin')
        tmx.nd.save(fname, {'a': a, 'c': c})
        got = mx.nd.load(fname)
        np.testing.assert_array_equal(got['c'].asnumpy(), c.asnumpy())


@pytest.mark.parametrize('keyed', [True, False], ids=['dict', 'list'])
def test_load_of_a_bfloat16_entry_raises_mxnet_error(keyed):
    """The reference's ``nd.save`` writes a bfloat16 array with dtype
    string '<V2', which no NDArray type holds: the port's ``load`` names
    the entry and the dtype in an MXNetError."""
    arrays = [mx.nd.array(np.arange(4.0), dtype='float32'),
              mx.nd.array(np.arange(6.0).reshape(2, 3), dtype='bfloat16')]
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, 'bf16.params')
        mx.nd.save(fname, {'w32': arrays[0], 'w16': arrays[1]} if keyed
                   else arrays)
        with pytest.raises(tmx.MXNetError, match="<V2") as err:
            tmx.nd.load(fname)
    assert ("'w16'" if keyed else 'entry 1') in str(err.value)


def test_onehot_encode_and_one_hot_match_jax():
    idx = np.array([0.0, 2.0, 1.0], np.float32)
    res = []
    for pkg in (tmx, mx):
        out = pkg.nd.zeros((3, 4))
        pkg.nd.onehot_encode(pkg.nd.array(idx), out)
        res.append(out.asnumpy())
    np.testing.assert_array_equal(res[0], res[1])
    np.testing.assert_array_equal(res[0][[0, 1, 2], [0, 2, 1]], 1)


def test_context_scope_places_creation():
    assert tmx.current_context() == tmx.cpu()
    with tmx.cpu(0) as ctx:
        assert tmx.current_context() is ctx
        assert tmx.nd.ones((2,)).context == tmx.cpu(0)
        assert tmx.nd.arange(3).context == tmx.cpu(0)
        assert tmx.nd._full(shape=(2,), value=1.0).context == tmx.cpu(0)
        assert tmx.random.uniform(shape=(2,)).context == tmx.cpu(0)
        with tmx.gpu(0):
            assert tmx.context.compute_context() == tmx.gpu(0)
    assert tmx.current_context() == tmx.cpu()
    # outside any scope (a fresh thread has none): the host containers
    # default to cpu(0), every other creation entry point to the card
    seen = []
    t = threading.Thread(target=lambda: seen.extend(
        [tmx.current_context(), tmx.context.compute_context()]))
    t.start()
    t.join()
    assert seen == [tmx.cpu(0), tmx.gpu(0)]


def test_mixed_contexts_raise():
    """As in the JAX package and the reference: an op on arrays of two
    devices raises, and nothing is moved to the first one's device."""
    host = tmx.nd.array(np.ones((2, 2), np.float32))
    other = tmx.nd.NDArray(torch.ones(2, 2, device='meta'), tmx.gpu(0))
    for call in (lambda: tmx.nd.broadcast_add(host, other),
                 lambda: tmx.nd.add_n(host, other),
                 lambda: tmx.nd.dot(other, host),
                 lambda: host + other, lambda: other * host):
        with pytest.raises(tmx.MXNetError, match='as_in_context'):
            call()


def test_random_moments_seed_and_out():
    """mx.random as in tests/test_random.py (moments of 10^4 draws, the
    same bounds), and seed determinism."""
    tmx.random.seed(42)
    u = tmx.random.uniform(-2.0, 3.0, shape=(1000,)).asnumpy()
    assert u.min() >= -2.0 and u.max() <= 3.0 and abs(u.mean() - 0.5) < 0.2
    n = tmx.random.normal(1.0, 2.0, shape=(10000,)).asnumpy()
    assert abs(n.mean() - 1.0) < 0.1 and abs(n.std() - 2.0) < 0.1
    tmx.random.seed(7)
    a = tmx.random.uniform(0, 1, shape=(50,)).asnumpy()
    tmx.random.seed(7)
    b = tmx.random.uniform(0, 1, shape=(50,)).asnumpy()
    c = tmx.random.uniform(0, 1, shape=(50,)).asnumpy()
    assert np.array_equal(a, b) and not np.array_equal(b, c)
    dst = tmx.nd.zeros((20,))
    assert tmx.random.uniform(0.5, 1.5, out=dst) is dst
    v = dst.asnumpy()
    assert v.min() >= 0.5 and v.max() <= 1.5
    for pkg in (tmx, mx):
        pkg.random.seed(3)
        s = pkg.nd.normal(loc=2.0, scale=0.5, shape=(20000,)).asnumpy()
        assert abs(s.mean() - 2.0) < 0.02 and abs(s.std() - 0.5) < 0.02


def test_dropout_and_rrelu_draws():
    """Dropout keeps about 1 - p of the entries, scaled by 1 / (1 - p),
    in both packages; rrelu's negative slopes lie in its bounds."""
    x = np.ones((100, 100), np.float32)
    for pkg in (tmx, mx):
        out = pkg.nd.Dropout(pkg.nd.array(x), p=0.3).asnumpy()
        kept = out != 0
        assert abs(kept.mean() - 0.7) < 0.03
        np.testing.assert_allclose(out[kept], 1 / 0.7, rtol=1e-6)
    neg = -np.ones((50, 50), np.float32)
    r = tmx.nd.LeakyReLU(tmx.nd.array(neg), act_type='rrelu').asnumpy()
    assert np.all(r <= -0.125) and np.all(r >= -0.334) and r.std() > 0
