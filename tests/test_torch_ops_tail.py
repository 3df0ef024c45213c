"""The last ops of the PyTorch port against the JAX package's
``get_op(name).apply`` on the same numpy inputs, forward and gradient:
``ctc_loss`` (padded labels, per-row data and label lengths) and
``WarpCTC`` (its backward injects the CTC gradient), and the six vision
ops GridGenerator (affine and warp), BilinearSampler,
SpatialTransformer, ROIPooling, Correlation (multiply and absolute
difference, stride and padding) and IdentityAttachKLSparseReg (its
hand-written backward and its moving average).

The gradient is the vjp of ``sum(out * cot)`` for a random cotangent,
taken by ``jax.vjp`` and by ``torch.autograd``.  Tolerances: forward
rtol 1e-5, atol 1e-6 in float32; gradients through CTC's recurrence over
T rtol 1e-4, atol 1e-5 (the summation order differs), elsewhere rtol
1e-5, atol 1e-6.  Sampling grids come from non-identity transforms, so
no sample point lies on a pixel boundary where floor() could round the
other way in the other package."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_op
from mxnet_tpu_torch.ops import get_op as torch_op

R = np.random.RandomState(53)


def _n(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _theta(n):
    """Affine transforms near a scaled rotation (no exact pixel hits)."""
    t = np.tile(np.array([0.83, -0.21, 0.07, 0.19, 0.77, -0.05],
                         np.float32), (n, 1))
    return t + _n(n, 6, scale=0.05)


def _ctc_case(lengths):
    t, n, c, l = 12, 3, 6, 4
    labels = np.zeros((n, l), np.float32)
    labels[0, :4] = [1, 2, 2, 3]          # a repeat: the skip edge is off
    labels[1, :2] = [4, 1]
    labels[2, :3] = [5, 5, 5]
    inputs = [_n(t, n, c), labels]
    if lengths:
        inputs += [np.array([12, 9, 11], np.float32),
                   np.array([4, 2, 3], np.float32)]
    return inputs


def _rois():
    return np.array([[0, 2.0, 3.0, 11.0, 9.0],
                     [1, 0.0, 0.0, 15.0, 15.0],
                     [0, 6.5, 1.2, 7.4, 14.9],
                     [1, 12.0, 12.0, 30.0, 30.0]], np.float32)


# name: (op, attrs, inputs, differentiated input indices, aux, rtol, atol)
CASES = {
    'ctc_loss': ('ctc_loss', {}, lambda: _ctc_case(False), (0,), (),
                 1e-4, 1e-5),
    'ctc_loss_lengths': ('ctc_loss', {'use_data_lengths': True,
                                      'use_label_lengths': True},
                         lambda: _ctc_case(True), (0,), (), 1e-4, 1e-5),
    'ctc_loss_blank_last': ('ctc_loss', {'blank_label': 5},
                            lambda: [_n(7, 2, 6), np.array(
                                [[1, 2, 5], [0, 5, 5]], np.float32)],
                            (0,), (), 1e-4, 1e-5),
    'warpctc': ('WarpCTC', {'label_length': 3, 'input_length': 8,
                            'grad_scale': 0.5},
                lambda: [_n(8 * 2, 5), np.array([1, 2, 2, 3, 4, 1],
                                               np.float32)],
                (0,), (), 1e-4, 1e-5),
    'grid_affine': ('GridGenerator', {'transform_type': 'affine',
                                      'target_shape': (5, 7)},
                    lambda: [_theta(2)], (0,), (), 1e-5, 1e-6),
    'grid_warp': ('GridGenerator', {'transform_type': 'warp'},
                  lambda: [_n(2, 2, 4, 5)], (0,), (), 1e-5, 1e-6),
    'bilinear_sampler': ('BilinearSampler', {},
                         lambda: [_n(2, 3, 6, 7),
                                  np.clip(_n(2, 2, 4, 5, scale=0.6), -1.2,
                                          1.2)], (0, 1), (), 1e-5, 1e-6),
    'spatial_transformer': ('SpatialTransformer', {'target_shape': (5, 6)},
                            lambda: [_n(2, 3, 8, 9), _theta(2)], (0, 1), (),
                            1e-5, 1e-6),
    'roi_pooling': ('ROIPooling', {'pooled_size': (3, 2),
                                   'spatial_scale': 0.5},
                    lambda: [_n(2, 3, 9, 10), _rois()], (0,), (), 1e-5, 1e-6),
    'roi_pooling_7x7': ('ROIPooling', {'pooled_size': (7, 7),
                                       'spatial_scale': 1.0 / 16},
                        lambda: [_n(2, 4, 12, 12), _rois() * np.array(
                            [1, 16, 16, 16, 16], np.float32)], (0,), (),
                        1e-5, 1e-6),
    'correlation': ('Correlation', {'max_displacement': 2, 'pad_size': 2},
                    lambda: [_n(2, 4, 6, 7), _n(2, 4, 6, 7)], (0, 1), (),
                    1e-5, 1e-6),
    'correlation_abs_stride': ('Correlation', {
        'max_displacement': 3, 'stride2': 2, 'is_multiply': False},
        lambda: [_n(1, 3, 5, 6), _n(1, 3, 5, 6)], (0, 1), (), 1e-5, 1e-6),
    'kl_sparse_reg': ('IdentityAttachKLSparseReg', {'sparseness_target': 0.2,
                                                    'penalty': 0.01,
                                                    'momentum': 0.8},
                      lambda: [(R.rand(6, 5) * 0.9 + 0.05)
                               .astype(np.float32),
                               (R.rand(5) * 0.5).astype(np.float32)],
                      (0,), (1,), 1e-5, 1e-6),
}


def _jax_run(op, attrs, inputs, diff, cots):
    def f(*xs):
        args = list(inputs)
        for i, x in zip(diff, xs):
            args[i] = x
        return op.apply(attrs, [jnp.asarray(a) for a in args], True,
                        jax.random.PRNGKey(0))

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
    return ([o.detach().numpy() for o in outs],
            {k: v.detach().numpy() for k, v in aux.items()},
            [args[i].grad.numpy() for i in diff])


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_forward_and_gradient_match_jax(case):
    name, attrs, make, diff, _, rtol, atol = CASES[case]
    inputs = make()
    jop, top = jax_op(name), torch_op(name)
    jattrs, tattrs = jop.canon_attrs(attrs), top.canon_attrs(attrs)
    probe = top.apply(tattrs, [torch.from_numpy(a) for a in inputs], True,
                      None)[0]
    cots = [_n(*o.shape) for o in probe]
    jouts, jaux, jgrads = _jax_run(jop, jattrs, inputs, diff, cots)
    touts, taux, tgrads = _torch_run(top, tattrs, inputs, diff, cots)
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == j.shape, (k, t.shape, j.shape)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6,
                                   err_msg='output %d' % k)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for i, t, j in zip(diff, tgrads, jgrads):
        assert np.abs(j).max() > 0, 'gradient of input %d is zero' % i
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                   err_msg='grad of input %d' % i)


@pytest.mark.parametrize('name,attrs,shapes,want', [
    ('WarpCTC', {'label_length': 3, 'input_length': 8},
     {'data': (16, 5)}, (16, 5)),
    ('ctc_loss', {}, {'data': (12, 3, 6), 'label': (3, 4)}, (3,)),
    ('ROIPooling', {'pooled_size': (7, 7), 'spatial_scale': 0.0625},
     {'data': (2, 8, 38, 38), 'rois': (5, 5)}, (5, 8, 7, 7)),
    ('Correlation', {'max_displacement': 4, 'stride2': 2},
     {'data1': (1, 8, 12, 12), 'data2': (1, 8, 12, 12)}, (1, 25, 12, 12)),
    ('SpatialTransformer', {'target_shape': (10, 12)},
     {'data': (2, 3, 20, 20), 'loc': (2, 6)}, (2, 3, 10, 12))])
def test_shape_inference_matches_jax(name, attrs, shapes, want):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as tmx
    got = {}
    for pkg in (tmx, mx):
        ins = [pkg.sym.Variable(k) for k in shapes]
        s = getattr(pkg.sym, name)(*ins, name='op', **attrs)
        got[pkg] = s.infer_shape(**shapes)
    assert got[tmx] == got[mx]
    assert tuple(got[tmx][1][0]) == want
