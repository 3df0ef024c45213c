"""The port's ``Pooling`` op against the JAX package's on the CPU: 1-D
and 3-D windows (max / avg / sum, 'valid' / 'full', pad 0 and 1),
forward and gradient, on tie-free data (a max window never holds two
equal values, so both packages route its gradient to the same cell).
float32, rtol 1e-5 / atol 1e-6: the window sums run in another order in
XLA's reduce_window and in torch's pools.

Global ``sum`` pooling is a recorded deviation (ROADMAP, reference
deviations): the port returns upstream MXNet's sum, the JAX op the
mean; the last test pins both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_op
from mxnet_tpu_torch.ops import get_op as torch_op

SHAPES = {'1d': (2, 3, 16), '3d': (2, 3, 4, 4, 4)}


def _tie_free(shape, seed):
    """Distinct values in a random order, spread over [-1, 1)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return ((rng.permutation(n) - n / 2) / (n / 2)).astype(
        np.float32).reshape(shape)


def _attrs(rank, pool_type, convention, pad):
    return {'kernel': (3,) * rank, 'stride': (2,) * rank, 'pad': (pad,) * rank,
            'pool_type': pool_type, 'pooling_convention': convention}


@pytest.mark.parametrize('pad', [0, 1])
@pytest.mark.parametrize('convention', ['valid', 'full'])
@pytest.mark.parametrize('pool_type', ['max', 'avg', 'sum'])
@pytest.mark.parametrize('rank', sorted(SHAPES))
def test_pooling_matches_jax(rank, pool_type, convention, pad):
    shape = SHAPES[rank]
    x = _tie_free(shape, 7)
    jop, top = jax_op('Pooling'), torch_op('Pooling')
    attrs = _attrs(len(shape) - 2, pool_type, convention, pad)
    jattrs, tattrs = jop.canon_attrs(attrs), top.canon_attrs(attrs)

    def jfwd(a):
        return jop.apply(jattrs, [a], False, None)[0][0]

    want = np.asarray(jfwd(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = top.apply(tattrs, [xt], False, None)[0][0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    # the gradient of a weighted sum of the outputs
    g = _tie_free(want.shape, 8)
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jfwd(a) * g))(
        jnp.asarray(x)))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=1e-5, atol=1e-6)
    if pool_type == 'max':     # every output cell routes to one input
        assert np.count_nonzero(jgrad) == np.count_nonzero(
            xt.grad.numpy()) > 0


def test_global_sum_pool_is_the_sum_where_the_jax_op_gives_the_mean():
    """The deviation, pinned on (2, 3, 9, 9): the port's global sum pool
    returns the sum over the window, the JAX op's the mean."""
    x = _tie_free((2, 3, 9, 9), 9)
    attrs = {'kernel': (1, 1), 'global_pool': True, 'pool_type': 'sum'}
    jop, top = jax_op('Pooling'), torch_op('Pooling')
    jmean = np.asarray(jop.apply(jop.canon_attrs(attrs), [jnp.asarray(x)],
                                 False, None)[0][0])
    tsum = top.apply(top.canon_attrs(attrs), [torch.from_numpy(x)], False,
                     None)[0][0].numpy()
    assert tsum.shape == jmean.shape == (2, 3, 1, 1)
    np.testing.assert_allclose(tsum, x.sum(axis=(2, 3), keepdims=True),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jmean, x.mean(axis=(2, 3), keepdims=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsum, jmean * 81, rtol=1e-5, atol=1e-5)
    assert np.abs(tsum - jmean).max() > 1.0
