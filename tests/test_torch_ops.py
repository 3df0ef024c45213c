"""Forward parity of each op of the ported serving path: the PyTorch
port's registry (mxnet_tpu_torch.ops) against the JAX package's
(get_op(name).apply), on the same numpy-seeded inputs.  float32,
rtol 1e-5 / atol 1e-5: convolution and matmul sum in another order in
XLA and in PyTorch's CPU kernels."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_op
from mxnet_tpu_torch.ops import get_op as torch_op

R = np.random.RandomState(11)


def _n(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _pos(*shape):
    return (R.rand(*shape) + 0.5).astype(np.float32)


CASES = {
    'conv1x1': ('Convolution', {'kernel': (1, 1), 'num_filter': 16,
                                'no_bias': True},
                lambda: [_n(2, 8, 6, 6), _n(16, 8, 1, 1)]),
    'conv3x3_s2_bias': ('Convolution', {'kernel': (3, 3), 'num_filter': 6,
                                        'stride': (2, 2), 'pad': (1, 1)},
                        lambda: [_n(2, 4, 9, 9), _n(6, 4, 3, 3), _n(6)]),
    'conv7x7_s2': ('Convolution', {'kernel': (7, 7), 'num_filter': 8,
                                   'stride': (2, 2), 'pad': (3, 3),
                                   'no_bias': True},
                   lambda: [_n(2, 3, 16, 16), _n(8, 3, 7, 7, scale=0.2)]),
    'conv3x3_pad_hi': ('Convolution', {'kernel': (4, 4), 'num_filter': 5,
                                       'pad': (2, 2), 'pad_hi': (1, 1),
                                       'no_bias': True},
                       lambda: [_n(1, 12, 8, 8), _n(5, 12, 4, 4)]),
    'conv1d_s2': ('Convolution', {'kernel': (3,), 'num_filter': 4,
                                  'stride': (2,), 'pad': (1,)},
                  lambda: [_n(2, 3, 11), _n(4, 3, 3), _n(4)]),
    'maxpool3x3_s2_p1': ('Pooling', {'kernel': (3, 3), 'stride': (2, 2),
                                     'pad': (1, 1), 'pool_type': 'max'},
                         lambda: [_n(2, 4, 9, 9)]),
    'maxpool_full': ('Pooling', {'kernel': (3, 3), 'stride': (2, 2),
                                 'pool_type': 'max',
                                 'pooling_convention': 'full'},
                     lambda: [_n(1, 3, 8, 8)]),
    'avgpool2x2': ('Pooling', {'kernel': (2, 2), 'stride': (2, 2),
                               'pool_type': 'avg'},
                   lambda: [_n(2, 3, 6, 6)]),
    'sumpool3x3': ('Pooling', {'kernel': (3, 3), 'stride': (1, 1),
                               'pad': (1, 1), 'pool_type': 'sum'},
                   lambda: [_n(2, 3, 5, 5)]),
    'global_maxpool': ('Pooling', {'kernel': (1, 1), 'global_pool': True,
                                   'pool_type': 'max'},
                       lambda: [_n(2, 4, 3, 3)]),
    'global_avgpool': ('Pooling', {'kernel': (7, 7), 'global_pool': True,
                                   'pool_type': 'avg'},
                       lambda: [_n(2, 16, 7, 7)]),
    'fullyconnected': ('FullyConnected', {'num_hidden': 10},
                       lambda: [_n(4, 3, 2, 2), _n(10, 12), _n(10)]),
    'relu': ('Activation', {'act_type': 'relu'}, lambda: [_n(3, 5, 4)]),
    'sigmoid': ('Activation', {'act_type': 'sigmoid'}, lambda: [_n(3, 7)]),
    'batchnorm_inference': ('BatchNorm', {'fix_gamma': False, 'eps': 2e-5},
                            lambda: [_n(2, 6, 5, 5), _pos(6), _n(6),
                                     _n(6, scale=0.1), _pos(6)]),
    'batchnorm_fix_gamma': ('BatchNorm', {'eps': 1e-3},
                            lambda: [_n(2, 6, 5, 5), _pos(6), _n(6),
                                     _n(6, scale=0.1), _pos(6)]),
    'softmaxoutput': ('SoftmaxOutput', {},
                      lambda: [_n(4, 10, scale=3.0),
                               np.arange(4, dtype=np.float32)]),
    '_plus': ('_plus', {}, lambda: [_n(2, 3, 4), _n(2, 3, 4)]),
    'identity': ('identity', {}, lambda: [_n(3, 4)]),
    'fused_bn_relu': ('fused_bn_relu', {},
                      lambda: [_n(2, 6, 3, 3), _pos(6), _n(6)]),
    'flatten': ('Flatten', {}, lambda: [_n(2, 3, 4, 5)]),
    'reshape': ('Reshape', {'shape': (0, -3, -1)}, lambda: [_n(2, 3, 4, 5)]),
    'transpose': ('transpose', {'axes': (0, 2, 3, 1)},
                  lambda: [_n(2, 3, 4, 5)]),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(case):
    name, attrs, make = CASES[case]
    inputs = make()
    jop, top = jax_op(name), torch_op(name)
    want, _ = jop.apply(jop.canon_attrs(attrs),
                        [jnp.asarray(a) for a in inputs], False, None)
    got, _ = top.apply(top.canon_attrs(attrs),
                       [torch.from_numpy(a) for a in inputs], False, None)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_batchnorm_training_stats_match_jax():
    """Training mode: batch statistics and the moving-stat updates."""
    inputs = [_n(4, 6, 5, 5), _pos(6), _n(6), _n(6, scale=0.1), _pos(6)]
    attrs = {'fix_gamma': False, 'eps': 2e-5, 'momentum': 0.9}
    jop, top = jax_op('BatchNorm'), torch_op('BatchNorm')
    want, waux = jop.apply(jop.canon_attrs(attrs),
                           [jnp.asarray(a) for a in inputs], True, None)
    got, gaux = top.apply(top.canon_attrs(attrs),
                          [torch.from_numpy(a) for a in inputs], True, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    assert sorted(gaux) == sorted(waux)
    for k in waux:
        np.testing.assert_allclose(gaux[k].numpy(), np.asarray(waux[k]),
                                   rtol=1e-5, atol=1e-5)
