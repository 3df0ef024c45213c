"""The 14 nn ops this slice adds to the PyTorch port, forward and gradient
against the JAX package's ``get_op(name).apply`` on the same numpy
inputs: Deconvolution (DCGAN's 4x4 stride-2 generator layer, adj,
num_group, bias, target_shape, 1-D), the regression outputs and
SVMOutput (their backward ignores the head gradient), CuDNNBatchNorm
(training statistics and aux updates), L2Normalization (three modes),
LRN, UpSampling (nearest, several inputs, bilinear), Crop (offset,
centre, crop_like), SequenceLast / SequenceMask / SequenceReverse (with
and without lengths) and softmax_cross_entropy.

The gradient is the vjp of ``sum(out * cot)`` for a random cotangent,
taken by ``jax.vjp`` and by ``torch.autograd``.  Tolerances: where the
arithmetic is exact (integer-valued data, weights and cotangents through
a transposed convolution, slicing, gathers, masks) the results must be
equal; elsewhere rtol 1e-5, atol 1e-6 in float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_op
from mxnet_tpu_torch.ops import get_op as torch_op

R = np.random.RandomState(23)


def _n(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _i(*shape, lo=-3, hi=4):
    return R.randint(lo, hi, shape).astype(np.float32)


def _labels(n, classes):
    return R.randint(0, classes, n).astype(np.float32)


# name: (op, attrs, inputs, differentiated input indices, exact)
CASES = {
    'deconv_dcgan': ('Deconvolution', {'kernel': (4, 4), 'stride': (2, 2),
                                       'pad': (1, 1), 'num_filter': 3},
                     lambda: [_i(2, 4, 4, 4), _i(4, 3, 4, 4)], (0, 1), True),
    'deconv_adj_group_bias': ('Deconvolution', {
        'kernel': (3, 3), 'stride': (2, 2), 'pad': (1, 1), 'adj': (1, 1),
        'num_filter': 6, 'num_group': 2, 'no_bias': False},
        lambda: [_i(1, 4, 5, 5), _i(4, 3, 3, 3), _i(6)], (0, 1, 2), True),
    'deconv_target_shape': ('Deconvolution', {
        'kernel': (4, 4), 'stride': (2, 2), 'num_filter': 3,
        'target_shape': (10, 10)},
        lambda: [_i(1, 2, 5, 5), _i(2, 3, 4, 4)], (0, 1), True),
    'deconv1d_dilate': ('Deconvolution', {'kernel': (3,), 'stride': (2,),
                                          'dilate': (2,), 'num_filter': 2},
                        lambda: [_i(2, 3, 6), _i(3, 2, 3)], (0, 1), True),
    'linear_regression': ('LinearRegressionOutput', {'grad_scale': 0.5},
                          lambda: [_n(4, 3), _n(4, 3)], (0,), False),
    'mae_regression': ('MAERegressionOutput', {},
                       lambda: [_n(4, 3), _n(4, 3)], (0,), False),
    'logistic_regression': ('LogisticRegressionOutput', {'grad_scale': 2.0},
                            lambda: [_n(6, 2), (R.rand(6, 2) > 0.5)
                                     .astype(np.float32)], (0,), False),
    'linear_regression_1d': ('LinearRegressionOutput', {},
                             lambda: [_n(5), _n(5)], (0,), False),
    'svm_squared': ('SVMOutput', {'margin': 0.5,
                                  'regularization_coefficient': 2.0},
                    lambda: [_n(4, 5), _labels(4, 5)], (0,), False),
    'svm_linear': ('SVMOutput', {'use_linear': True},
                   lambda: [_n(4, 5), _labels(4, 5)], (0,), False),
    'cudnn_batchnorm': ('CuDNNBatchNorm', {'fix_gamma': False, 'eps': 2e-5},
                        lambda: [_n(3, 4, 2, 2), _n(4), _n(4), _n(4),
                                 (R.rand(4) + 0.5).astype(np.float32)],
                        (0, 1, 2), False),
    'l2norm_instance': ('L2Normalization', {},
                        lambda: [_n(3, 4, 2, 2)], (0,), False),
    'l2norm_channel': ('L2Normalization', {'mode': 'channel'},
                       lambda: [_n(2, 5, 3, 3)], (0,), False),
    'l2norm_spatial': ('L2Normalization', {'mode': 'spatial', 'eps': 1e-6},
                       lambda: [_n(2, 3, 4, 4)], (0,), False),
    'lrn': ('LRN', {'nsize': 5, 'alpha': 1e-2, 'beta': 0.75, 'knorm': 2.0},
            lambda: [_n(2, 7, 3, 3, scale=2.0)], (0,), False),
    'lrn_nsize3': ('LRN', {'nsize': 3},
                   lambda: [_n(2, 4, 5, 5)], (0,), False),
    'upsampling_nearest': ('UpSampling', {'scale': 2},
                           lambda: [_n(2, 3, 3, 4)], (0,), True),
    'upsampling_nearest_two_inputs': ('UpSampling', {'scale': 3,
                                                     'num_args': 2},
                                      lambda: [_n(1, 2, 3, 3),
                                               _n(1, 2, 3, 3)], (0,), True),
    'upsampling_bilinear': ('UpSampling', {'scale': 2,
                                           'sample_type': 'bilinear',
                                           'num_filter': 3},
                            lambda: [_n(2, 3, 4, 5)], (0,), False),
    'crop_hw_offset': ('Crop', {'h_w': (3, 4), 'offset': (1, 2)},
                       lambda: [_n(2, 3, 6, 7)], (0,), True),
    'crop_center': ('Crop', {'h_w': (4, 4), 'center_crop': True},
                    lambda: [_n(1, 2, 7, 8)], (0,), True),
    'crop_like': ('Crop', {'num_args': 2},
                  lambda: [_n(2, 3, 8, 8), _n(2, 3, 5, 6)], (0,), True),
    'sequence_last': ('SequenceLast', {}, lambda: [_n(5, 3, 4)], (0,), True),
    'sequence_last_lengths': ('SequenceLast', {'use_sequence_length': True},
                              lambda: [_n(5, 3, 4),
                                       np.array([2, 5, 1], np.float32)],
                              (0,), True),
    'sequence_mask_lengths': ('SequenceMask', {'use_sequence_length': True,
                                               'value': -1.5},
                              lambda: [_n(5, 3, 2, 2),
                                       np.array([0, 5, 3], np.float32)],
                              (0,), True),
    'sequence_mask': ('SequenceMask', {}, lambda: [_n(4, 2)], (0,), True),
    'sequence_reverse_lengths': ('SequenceReverse',
                                 {'use_sequence_length': True},
                                 lambda: [_n(6, 3, 4),
                                          np.array([6, 2, 4], np.float32)],
                                 (0,), True),
    'sequence_reverse': ('SequenceReverse', {}, lambda: [_n(4, 2, 3)],
                         (0,), True),
    'softmax_cross_entropy': ('softmax_cross_entropy', {},
                              lambda: [_n(4, 6, scale=2.0),
                                       np.array([0, 5, -1, 2], np.float32)],
                              (0,), False),
}


def _jax_run(op, attrs, inputs, diff, cots):
    def f(*xs):
        args = list(inputs)
        for i, x in zip(diff, xs):
            args[i] = x
        outs, aux = op.apply(attrs, [jnp.asarray(a) for a in args], True,
                             jax.random.PRNGKey(0))
        return outs, aux

    (outs, aux), vjp = jax.vjp(f, *[jnp.asarray(inputs[i]) for i in diff])
    grads = vjp(([jnp.asarray(c) for c in cots],
                 jax.tree_util.tree_map(jnp.zeros_like, aux)))
    return ([np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in aux.items()},
            [np.asarray(g) for g in grads])


def _torch_run(op, attrs, inputs, diff, cots):
    args = [torch.from_numpy(a.copy()) for a in inputs]
    for i in diff:
        args[i].requires_grad_(True)
    outs, aux = op.apply(attrs, args, True, None)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    grads = [args[i].grad if args[i].grad is not None
             else torch.zeros_like(args[i]) for i in diff]
    return ([o.detach().numpy() for o in outs],
            {k: v.detach().numpy() for k, v in aux.items()},
            [g.numpy() for g in grads])


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_forward_and_gradient_match_jax(case):
    name, attrs, make, diff, exact = CASES[case]
    inputs = make()
    jop, top = jax_op(name), torch_op(name)
    jattrs, tattrs = jop.canon_attrs(attrs), top.canon_attrs(attrs)
    # forward shapes first, for the cotangents
    probe = top.apply(tattrs, [torch.from_numpy(a) for a in inputs], True,
                      None)[0]
    # integer-valued cotangents keep the exact cases' gradients exact
    cots = [_i(*o.shape) if exact else _n(*o.shape) for o in probe]
    jouts, jaux, jgrads = _jax_run(jop, jattrs, inputs, diff, cots)
    touts, taux, tgrads = _torch_run(top, tattrs, inputs, diff, cots)
    assert len(touts) == len(jouts)
    check = (np.testing.assert_array_equal if exact else
             lambda a, b, err_msg: np.testing.assert_allclose(
                 a, b, rtol=1e-5, atol=1e-6, err_msg=err_msg))
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == j.shape, (k, t.shape, j.shape)
        check(t, j, err_msg='output %d' % k)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        check(taux[k], jaux[k], err_msg=k)
    for i, t, j in zip(diff, tgrads, jgrads):
        check(t, j, err_msg='grad of input %d' % i)


def test_deconvolution_shapes_follow_the_reference():
    """Shape inference through the registry's complete_shapes: DCGAN's
    generator widths (nz 100 -> ngf*8 at 4x4 from 1x1, then x2 per layer)
    in both packages."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as tmx
    got = {}
    for pkg in (tmx, mx):
        z = pkg.sym.Variable('data')
        g1 = pkg.sym.Deconvolution(z, kernel=(4, 4), num_filter=512,
                                   name='g1')
        g2 = pkg.sym.Deconvolution(g1, kernel=(4, 4), stride=(2, 2),
                                   pad=(1, 1), num_filter=256, name='g2')
        got[pkg] = g2.infer_shape(data=(64, 100, 1, 1))
    assert got[tmx] == got[mx]
    assert got[tmx][1] == [(64, 256, 8, 8)]
    assert got[tmx][0][1] == (100, 512, 4, 4)


def test_alexnet_builds_the_same_graph():
    """models/alexnet.py, the full-width user of LRN: the same symbol JSON
    as the JAX package's builder and the same shapes at 3x224x224."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as tmx
    # fresh name scopes: auto-named nodes count per scope
    with tmx.base.NameManager():
        tsym = tmx.models.get_symbol('alexnet', num_classes=1000)
    with mx.base.NameManager():
        jsym = mx.models.get_symbol('alexnet', num_classes=1000)
    assert tsym.tojson() == jsym.tojson()
    shapes = tsym.infer_shape(data=(32, 3, 224, 224))
    assert shapes == jsym.infer_shape(data=(32, 3, 224, 224))
    assert shapes[1] == [(32, 1000)]
    assert sum(n.op == 'LRN' for n in tsym.topo_nodes()) == 2
