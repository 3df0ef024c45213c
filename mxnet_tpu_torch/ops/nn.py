"""Neural-network layer operators.

The port of ``mxnet_tpu/ops/nn.py``: FullyConnected (``:49-76``),
Convolution (``_conv_apply``, ``:90-162``), Deconvolution (``:165-230``),
Pooling (``:325-378``), Activation (``:385-390``), LeakyReLU
(``:393-445``), softmax / log_softmax / SoftmaxActivation (``:447-458``),
SoftmaxOutput with its injected loss gradient (``:468-548``), the
regression outputs and SVMOutput (``:551-636``), BatchNorm with its
shared stats step and its CuDNNBatchNorm alias (``:645-735``),
InstanceNorm (``:741-756``), L2Normalization and LRN (``:759-797``),
Dropout (``:800-814``), Concat (``:821-831``), SliceChannel
(``:834-849``), Embedding (``:857-871``), UpSampling and Crop
(``:878-920``), the Sequence ops (``:923-967``), FlashAttention
(``:985-1032``) and ``softmax_cross_entropy``
(``mxnet_tpu/ops/vision.py:227``).  The loss layers' backward ignores the
head gradient and injects its own, as in the reference.  The random draws of
rrelu and Dropout come from the per-device ``torch.Generator`` of
``random.py`` (the JAX ops take a key).
Gradients come from ``torch.autograd``.  NCHW in and out,
weights in the reference layouts, so checkpoints interchange.  The JAX
package computes convolution and matmul outside any Pallas kernel
(``lax.conv_general_dilated``, ``jnp.dot``); here they are
``F.conv2d`` / ``torch.matmul``.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading

import torch
import torch.nn.functional as F

from .registry import alias, register, register_simple


def _complete(shapes, idx, value):
    if shapes[idx] is None:
        shapes[idx] = tuple(int(v) for v in value)
    return shapes


def _tup(v, n=2, default=1):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


# ---------------------------------------------------------------------------
# FullyConnected — weight layout (num_hidden, in), as in the reference
# ---------------------------------------------------------------------------

def _fc_apply(attrs, inputs, is_train, rng):
    data, weight = inputs[0], inputs[1]
    out = torch.matmul(data.reshape(data.shape[0], -1), weight.t())
    if not bool(attrs.get('no_bias', False)):
        out = out + inputs[2]
    return [out], {}


def _fc_complete(attrs, in_shapes):
    num_hidden = int(attrs['num_hidden'])
    data_shape = in_shapes[0]
    if data_shape is not None:
        in_dim = math.prod(data_shape[1:])
        _complete(in_shapes, 1, (num_hidden, in_dim))
    if not attrs.get('no_bias', False):
        _complete(in_shapes, 2, (num_hidden,))
    return in_shapes


register('FullyConnected', _fc_apply,
         input_names=lambda attrs: (['data', 'weight']
                                    if attrs.get('no_bias', False)
                                    else ['data', 'weight', 'bias']),
         num_outputs=lambda attrs: 1,
         complete_shapes=_fc_complete,
         attr_defaults={'no_bias': False}, hint='fullyconnected')


# ---------------------------------------------------------------------------
# Convolution — NCHW / OIHW (1-D: NCW / OIW)
# ---------------------------------------------------------------------------

def _conv_apply(attrs, inputs, is_train, rng):
    data, weight = inputs[0], inputs[1]
    kernel = tuple(attrs['kernel'])
    nd = len(kernel)
    if nd not in (1, 2):
        raise NotImplementedError('Convolution: %d-D kernels are not '
                                  'ported' % nd)
    stride = _tup(attrs.get('stride'), nd)
    dilate = _tup(attrs.get('dilate'), nd)
    pad = _tup(attrs.get('pad'), nd, default=0)
    # 'pad_hi': high-side padding when it differs from 'pad' (the
    # space-to-depth ResNet stem); absent -> symmetric padding
    pad_hi = attrs.get('pad_hi')
    pad_hi = _tup(pad_hi, nd) if pad_hi else pad
    groups = int(attrs.get('num_group', 1))
    conv = F.conv2d if nd == 2 else F.conv1d
    if pad == pad_hi:
        out = conv(data, weight, None, stride, pad, dilate, groups)
    else:
        # F.pad lists the LAST axis first
        widths = []
        for lo, hi in reversed(list(zip(pad, pad_hi))):
            widths += [lo, hi]
        out = conv(F.pad(data, widths), weight, None, stride, 0, dilate,
                   groups)
    if not bool(attrs.get('no_bias', False)):
        out = out + inputs[2].reshape((1, -1) + (1,) * nd)
    return [out], {}


def _conv_complete(attrs, in_shapes):
    kernel = tuple(attrs['kernel'])
    num_filter = int(attrs['num_filter'])
    groups = int(attrs.get('num_group', 1))
    data_shape = in_shapes[0]
    if data_shape is not None:
        _complete(in_shapes, 1,
                  (num_filter, data_shape[1] // groups) + kernel)
    if not attrs.get('no_bias', False):
        _complete(in_shapes, 2, (num_filter,))
    return in_shapes


register('Convolution', _conv_apply,
         input_names=lambda attrs: (['data', 'weight']
                                    if attrs.get('no_bias', False)
                                    else ['data', 'weight', 'bias']),
         num_outputs=lambda attrs: 1,
         complete_shapes=_conv_complete,
         attr_defaults={'no_bias': False, 'num_group': 1, 'stride': None,
                        'dilate': None, 'pad': None, 'workspace': 1024,
                        'cudnn_tune': None, 'cudnn_off': False,
                        'layout': None},
         hint='convolution')


# ---------------------------------------------------------------------------
# Deconvolution — the transposed convolution; weight (in_channels,
# num_filter / num_group, *kernel), the layout of torch's conv_transpose
# ---------------------------------------------------------------------------

def _deconv_apply(attrs, inputs, is_train, rng):
    data, weight = inputs[0], inputs[1]
    kernel = tuple(attrs['kernel'])
    nd = len(kernel)
    if nd not in (1, 2):
        raise NotImplementedError('Deconvolution: %d-D kernels are not '
                                  'ported' % nd)
    stride = _tup(attrs.get('stride'), nd)
    pad = _tup(attrs.get('pad'), nd, default=0)
    adj = _tup(attrs.get('adj'), nd, default=0)
    dilate = _tup(attrs.get('dilate'), nd)
    tshape = attrs.get('target_shape')
    if tshape:
        # the pad that makes the output target_shape (deconvolution-inl.h)
        tshape = _tup(tshape, nd)
        pad = tuple(((data.shape[2 + i] - 1) * stride[i]
                     + dilate[i] * (kernel[i] - 1) + 1 + adj[i]
                     - tshape[i]) // 2 for i in range(nd))
    deconv = F.conv_transpose2d if nd == 2 else F.conv_transpose1d
    # out = (in - 1) * stride - 2 * pad + dilate * (k - 1) + 1 + adj
    out = deconv(data, weight, None, stride, pad, adj,
                 int(attrs.get('num_group', 1)), dilate)
    if not bool(attrs.get('no_bias', True)):
        out = out + inputs[2].reshape((1, -1) + (1,) * nd)
    return [out], {}


def _deconv_complete(attrs, in_shapes):
    kernel = tuple(attrs['kernel'])
    num_filter = int(attrs['num_filter'])
    groups = int(attrs.get('num_group', 1))
    data_shape = in_shapes[0]
    if data_shape is not None:
        _complete(in_shapes, 1,
                  (data_shape[1], num_filter // groups) + kernel)
    if not attrs.get('no_bias', True):
        _complete(in_shapes, 2, (num_filter,))
    return in_shapes


register('Deconvolution', _deconv_apply,
         input_names=lambda attrs: (['data', 'weight']
                                    if attrs.get('no_bias', True)
                                    else ['data', 'weight', 'bias']),
         num_outputs=lambda attrs: 1,
         complete_shapes=_deconv_complete,
         attr_defaults={'no_bias': True, 'num_group': 1, 'stride': None,
                        'pad': None, 'adj': None, 'dilate': None,
                        'target_shape': None, 'workspace': 1024,
                        'cudnn_tune': None, 'layout': None},
         hint='deconvolution')


# ---------------------------------------------------------------------------
# Pooling — 'valid' and 'full' conventions; avg counts padded cells
# (count-include-pad, like mshadow's pool)
# ---------------------------------------------------------------------------

def _pool_out_dim(x, k, p, s, convention):
    if convention == 'full':
        return int(math.ceil(float(x + 2 * p - k) / s)) + 1
    return (x + 2 * p - k) // s + 1


def _pooling_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    pool_type = attrs.get('pool_type', 'max')
    if pool_type not in ('max', 'avg', 'sum'):
        raise ValueError('unknown pool_type %r' % pool_type)
    nd = data.ndim - 2
    if bool(attrs.get('global_pool', False)):
        axes = tuple(range(2, data.ndim))
        if pool_type == 'max':
            return [torch.amax(data, dim=axes, keepdim=True)], {}
        if pool_type == 'avg':
            return [torch.mean(data, dim=axes, keepdim=True)], {}
        # upstream MXNet's global sum; the JAX op returns the mean here
        # (ROADMAP, reference deviations)
        return [torch.sum(data, dim=axes, keepdim=True)], {}
    if nd not in (1, 2, 3):
        raise NotImplementedError('Pooling: %d-D windows' % nd)
    kernel = _tup(attrs['kernel'], nd)
    stride = _tup(attrs.get('stride'), nd)
    pad = _tup(attrs.get('pad'), nd, default=0)
    convention = attrs.get('pooling_convention', 'valid')
    # right-pad so the window walk emits exactly the convention's
    # output size (the JAX op's reduce_window padding rule)
    widths = []
    for i in reversed(range(nd)):
        out_d = _pool_out_dim(data.shape[2 + i], kernel[i], pad[i],
                              stride[i], convention)
        needed = (out_d - 1) * stride[i] + kernel[i] - data.shape[2 + i]
        widths += [pad[i], max(needed - pad[i], pad[i])]
    padded = F.pad(data, widths, value=float('-inf') if pool_type == 'max'
                   else 0.0)
    if nd == 1:
        # torch's 1-D average pool has no divisor_override: a 1-D window
        # pools as a 2-D one over a unit leading dimension
        padded, kernel, stride = padded[:, :, None], (1,) + kernel, \
            (1,) + stride
    if pool_type == 'max':
        pool = F.max_pool3d if len(kernel) == 3 else F.max_pool2d
        out = pool(padded, kernel, stride)
    else:
        pool = F.avg_pool3d if len(kernel) == 3 else F.avg_pool2d
        out = pool(padded, kernel, stride,
                   divisor_override=1 if pool_type == 'sum' else None)
    return [out[:, :, 0] if nd == 1 else out], {}


register('Pooling', _pooling_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'pool_type': 'max', 'global_pool': False,
                        'kernel': (1, 1), 'stride': None, 'pad': None,
                        'pooling_convention': 'valid', 'cudnn_off': False},
         hint='pooling')


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

_ACTS = {'relu': torch.relu, 'sigmoid': torch.sigmoid, 'tanh': torch.tanh,
         'softrelu': F.softplus}

register_simple('Activation',
                lambda x, act_type='relu': _ACTS[act_type](x),
                attr_defaults={'act_type': 'relu'}, hint='activation')


def _uniform_like(data, lower, upper):
    from ..random import generator
    return torch.empty_like(data).uniform_(lower, upper,
                                           generator=generator(data.device))


def _leaky_relu_apply(attrs, inputs, is_train, rng):
    act_type = attrs.get('act_type', 'leaky')
    slope = float(attrs.get('slope', 0.25))
    data = inputs[0]
    lower = float(attrs.get('lower_bound', 0.125))
    upper = float(attrs.get('upper_bound', 0.334))
    if act_type == 'leaky':
        neg = slope * data
    elif act_type == 'elu':
        neg = slope * (torch.exp(data) - 1.0)
    elif act_type == 'prelu':
        neg = inputs[1].reshape((1, -1) + (1,) * (data.ndim - 2)) * data
    elif act_type == 'rrelu':
        neg = (_uniform_like(data, lower, upper) if is_train
               else (lower + upper) / 2.0) * data
    else:
        raise ValueError('unknown act_type %s' % act_type)
    return [torch.where(data > 0, data, neg)], {}


def _leaky_complete(attrs, in_shapes):
    if attrs.get('act_type', 'leaky') == 'prelu' and in_shapes[0] is not None:
        _complete(in_shapes, 1, (in_shapes[0][1],))
    return in_shapes


def _leaky_relu_var_attrs(attrs, input_name):
    if input_name == 'gamma':
        # the prelu slope starts at the op's slope (leaky_relu-inl.h)
        return {'__init__': json.dumps(
            ['constant', {'value': float(attrs.get('slope', 0.25))}])}
    return None


register('LeakyReLU', _leaky_relu_apply,
         input_var_attrs=_leaky_relu_var_attrs,
         input_names=lambda attrs: (['data', 'gamma']
                                    if attrs.get('act_type', 'leaky') == 'prelu'
                                    else ['data']),
         num_outputs=lambda attrs: 1,
         complete_shapes=_leaky_complete,
         takes_rng=True,
         attr_defaults={'act_type': 'leaky', 'slope': 0.25,
                        'lower_bound': 0.125, 'upper_bound': 0.334},
         hint='leakyrelu')

register_simple('softmax', lambda x, axis=-1, temperature=1.0:
                torch.softmax(x / temperature, dim=int(axis)),
                attr_defaults={'axis': -1, 'temperature': 1.0})
register_simple('log_softmax', lambda x, axis=-1:
                torch.log_softmax(x, dim=int(axis)),
                attr_defaults={'axis': -1})
register_simple('SoftmaxActivation',
                lambda x, mode='instance': (
                    torch.softmax(x.reshape(x.shape[0], -1), dim=-1)
                    .reshape(x.shape) if mode == 'instance'
                    else torch.softmax(x, dim=1)),
                attr_defaults={'mode': 'instance'}, hint='softmaxactivation')


# ---------------------------------------------------------------------------
# SoftmaxOutput.  As in the reference, its backward injects the loss
# gradient and ignores the head gradient (softmax_output-inl.h Backward;
# the JAX op's custom_vjp, mxnet_tpu/ops/nn.py:468-527).
# ---------------------------------------------------------------------------

def _softmax_output_grad(prob, label, attrs, rows=None):
    """d(loss)/d(data) of softmax cross-entropy: ``prob - onehot(label)``
    with the op's ignore-label mask, normalization and grad_scale.
    ``rows``: the group of ranks whose rows make the global batch (a
    ``parallel.mesh.DpBatchStats``), whose divisor 'batch' and 'valid'
    take, or None."""
    multi = bool(attrs.get('multi_output', False))
    grad_scale = float(attrs.get('grad_scale', 1.0))
    use_ignore = bool(attrs.get('use_ignore', False))
    ignore_label = float(attrs.get('ignore_label', -1))
    normalization = attrs.get('normalization', 'null')
    # the one-hot of ops/tensor.py, as jax.nn.one_hot: a label outside
    # [0, C) (the padding -1 of BucketSentenceIter) gives a zero row, where
    # F.one_hot raises (and device-asserts on the card)
    from .tensor import _one_hot
    if multi:
        # data (N, C, ...), label (N, ...)
        onehot = _one_hot(label, prob.shape[1], dtype=prob.dtype) \
            .movedim(-1, 1)
    elif label.ndim == prob.ndim:
        onehot = label.to(prob.dtype)
    else:
        onehot = _one_hot(label, prob.shape[-1], dtype=prob.dtype)
    grad = prob - onehot
    valid = None
    if use_ignore and label.ndim < prob.ndim:
        mask = (label != ignore_label).to(prob.dtype)
        if multi:
            grad = grad * mask[:, None]
        else:
            grad = grad * mask.reshape(mask.shape
                                       + (1,) * (grad.ndim - mask.ndim))
        valid = torch.sum(mask)
    if normalization == 'batch':
        grad = grad / (prob.shape[0] if rows is None
                       else rows.loss_rows(prob.shape[0]))
    elif normalization == 'valid' and valid is not None:
        if rows is not None:
            valid = rows.psum_count(valid)
        grad = grad / torch.clamp(valid, min=1.0)
    return grad * grad_scale


def _softmax(d, attrs):
    if bool(attrs.get('multi_output', False)):
        return torch.softmax(d, dim=1)
    if bool(attrs.get('preserve_shape', False)) or d.ndim <= 2:
        return torch.softmax(d, dim=-1)
    return torch.softmax(d.reshape(d.shape[0], -1), dim=-1).reshape(d.shape)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; backward returns the injected loss gradient."""

    @staticmethod
    def forward(ctx, d, label, attrs):
        prob = _softmax(d, attrs)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        ctx.rows = _global_rows()
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad = _softmax_output_grad(prob, label, ctx.attrs,
                                    ctx.rows).to(prob.dtype)
        return grad, None, None


def _softmax_output_apply(attrs, inputs, is_train, rng):
    return [_SoftmaxOutputFn.apply(inputs[0], inputs[1], attrs)], {}


def _softmax_output_complete(attrs, in_shapes):
    d = in_shapes[0]
    if d is not None and in_shapes[1] is None:
        if bool(attrs.get('multi_output', False)):
            in_shapes[1] = (d[0],) + tuple(d[2:])
        else:
            in_shapes[1] = tuple(d[:-1]) if len(d) > 1 else (d[0],)
    return in_shapes


register('SoftmaxOutput', _softmax_output_apply,
         input_names=lambda attrs: ['data', 'label'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_softmax_output_complete,
         attr_defaults={'grad_scale': 1.0, 'ignore_label': -1.0,
                        'multi_output': False, 'use_ignore': False,
                        'preserve_shape': False, 'normalization': 'null',
                        'out_grad': False},
         hint='softmaxoutput')
alias('Softmax', 'SoftmaxOutput')


# ---------------------------------------------------------------------------
# Regression outputs and SVMOutput (regression_output-inl.h,
# svm_output-inl.h): the forward is the link function (identity for SVM),
# the backward the loss gradient, the head gradient ignored
# ---------------------------------------------------------------------------

class _LossFn(torch.autograd.Function):
    """``link(data)`` forward; backward ``grad(out, label, attrs)``."""

    @staticmethod
    def forward(ctx, d, label, link, grad, attrs):
        out = link(d)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.attrs = grad, attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        return (ctx.grad(out, label, ctx.attrs).to(out.dtype), None, None,
                None, None)


def _regression_grad(diff):
    def grad(out, label, attrs):
        # divided by the outputs per sample, as regression_output-inl.h
        num = float(math.prod(out.shape[1:])) if out.ndim > 1 else 1.0
        return diff(out, label.reshape(out.shape)) * (
            float(attrs.get('grad_scale', 1.0)) / num)
    return grad


def _regression_complete(attrs, in_shapes):
    if in_shapes[0] is not None and in_shapes[1] is None:
        in_shapes[1] = tuple(in_shapes[0])
    return in_shapes


for _name, _link, _diff in (
        ('LinearRegressionOutput', torch.clone, lambda o, l: o - l),
        ('MAERegressionOutput', torch.clone,
         lambda o, l: torch.sign(o - l)),
        ('LogisticRegressionOutput', torch.sigmoid, lambda o, l: o - l)):
    register(_name, lambda attrs, inputs, is_train, rng, _l=_link,
             _g=_regression_grad(_diff): (
                 [_LossFn.apply(inputs[0], inputs[1], _l, _g, attrs)], {}),
             input_names=lambda attrs: ['data', 'label'],
             num_outputs=lambda attrs: 1,
             complete_shapes=_regression_complete,
             attr_defaults={'grad_scale': 1.0}, hint=_name.lower())


def _svm_grad(d, label, attrs):
    from .tensor import _one_hot
    margin = float(attrs.get('margin', 1.0))
    reg_coef = float(attrs.get('regularization_coefficient', 1.0))
    lab = _one_hot(label, d.shape[1], dtype=d.dtype)
    score_correct = torch.sum(d * lab, dim=1, keepdim=True)
    if bool(attrs.get('use_linear', False)):
        viol = ((d - score_correct + margin) > 0).to(d.dtype)
    else:
        viol = torch.maximum(d - score_correct + margin,
                             torch.zeros_like(d))
    viol = viol * (1.0 - lab)
    return reg_coef * (viol - lab * torch.sum(viol, dim=1, keepdim=True))


def _svm_complete(attrs, in_shapes):
    if in_shapes[0] is not None and in_shapes[1] is None:
        in_shapes[1] = (in_shapes[0][0],)
    return in_shapes


register('SVMOutput',
         lambda attrs, inputs, is_train, rng: (
             [_LossFn.apply(inputs[0], inputs[1], torch.clone,
                            _svm_grad, attrs)], {}),
         input_names=lambda attrs: ['data', 'label'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_svm_complete,
         attr_defaults={'margin': 1.0, 'regularization_coefficient': 1.0,
                        'use_linear': False},
         hint='svmoutput')


# ---------------------------------------------------------------------------
# BatchNorm.  Aux moving stats are functional: updates are returned and
# written back by the executor.
# ---------------------------------------------------------------------------

_shared = threading.local()


@contextlib.contextmanager
def shared_batch_stats(group, index):
    """Inside the block, this thread's batch statistics are those of the
    rows of every member of ``group`` (``index`` is this thread's member):
    ``group.moments(index, x32, axes)`` gives the E[x] and E[x^2] of them
    all (``executor_group``'s executors of one batch, whose JAX
    counterpart is one program over the whole batch)."""
    prev = getattr(_shared, 'member', None)
    _shared.member = (group, index)
    try:
        yield
    finally:
        _shared.member = prev


def _global_rows():
    """The group whose rows make a loss head's global batch (a mesh's
    ``DpBatchStats``, which has ``loss_rows``), or None."""
    member = getattr(_shared, 'member', None)
    if member is None or not hasattr(member[0], 'loss_rows'):
        return None
    return member[0]


def _moments(x32, axes):
    member = getattr(_shared, 'member', None)
    if member is None:
        return torch.mean(x32, dim=axes), torch.mean(x32 * x32, dim=axes)
    group, index = member
    return group.moments(index, x32, axes)


def batch_norm_stats(data, moving_mean, moving_var, axes, momentum,
                     use_batch_stats):
    """Shared stats step: returns ``(mean, var, aux_updates)``.

    Batch statistics take the one-pass f32 E[x] / E[x^2] form of the
    JAX op, clamping the cancellation at zero; the gradient flows
    through the batch mean and variance (over the rows of a whole group
    inside :func:`shared_batch_stats`).  The moving statistics are
    never differentiated (their updates are detached, as the JAX op's
    ``stop_gradient``), and are cast to the data dtype when used.  Also
    the stats step of the fused BN ops (fuse.py) — ONE copy, so fused
    and unfused numerics agree.
    """
    if use_batch_stats:
        x32 = data.float()
        mean32, sq32 = _moments(x32, axes)
        # torch.maximum, not clamp: at a zero variance (a constant
        # channel) it splits the gradient 0.5/0.5 as jnp.maximum does
        var32 = torch.maximum(sq32 - mean32 * mean32,
                              torch.zeros_like(mean32))
        aux_updates = {
            'moving_mean': (momentum * moving_mean
                            + (1 - momentum) * mean32).detach(),
            'moving_var': (momentum * moving_var
                           + (1 - momentum) * var32).detach(),
        }
        return mean32.to(data.dtype), var32.to(data.dtype), aux_updates
    return (moving_mean.detach().to(data.dtype),
            moving_var.detach().to(data.dtype), {})


def _batch_norm_apply(attrs, inputs, is_train, rng):
    data, gamma, beta, moving_mean, moving_var = inputs
    eps = float(attrs.get('eps', 1e-3))
    momentum = float(attrs.get('momentum', 0.9))
    fix_gamma = bool(attrs.get('fix_gamma', True))
    use_global = bool(attrs.get('use_global_stats', False))
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    mean, var, aux_updates = batch_norm_stats(
        data, moving_mean, moving_var, axes, momentum,
        is_train and not use_global)
    inv = torch.rsqrt(var.reshape(bshape) + eps)
    out = ((data - mean.reshape(bshape)) * inv * g.reshape(bshape)
           + beta.reshape(bshape)).to(data.dtype)
    outs = [out]
    if bool(attrs.get('output_mean_var', False)):
        outs += [mean, torch.rsqrt(var + eps)]
    return outs, aux_updates


def _bn_complete(attrs, in_shapes):
    if in_shapes[0] is not None:
        c = in_shapes[0][1]
        for i in (1, 2):
            _complete(in_shapes, i, (c,))
    return in_shapes


register('BatchNorm', _batch_norm_apply,
         input_names=lambda attrs: ['data', 'gamma', 'beta'],
         num_outputs=lambda attrs: (3 if attrs.get('output_mean_var', False)
                                    else 1),
         aux_names=lambda attrs: ['moving_mean', 'moving_var'],
         complete_shapes=_bn_complete,
         attr_defaults={'eps': 1e-3, 'momentum': 0.9, 'fix_gamma': True,
                        'use_global_stats': False, 'output_mean_var': False},
         hint='batchnorm')
register('CuDNNBatchNorm', _batch_norm_apply,
         input_names=lambda attrs: ['data', 'gamma', 'beta'],
         num_outputs=lambda attrs: 1,
         aux_names=lambda attrs: ['moving_mean', 'moving_var'],
         complete_shapes=_bn_complete,
         attr_defaults={'eps': 1e-3, 'momentum': 0.9, 'fix_gamma': True,
                        'use_global_stats': False},
         hint='cudnnbatchnorm')


# ---------------------------------------------------------------------------
# InstanceNorm — the transformer LM's layer norm (over a (N, 1, E) view)
# ---------------------------------------------------------------------------

def _instance_norm_apply(attrs, inputs, is_train, rng):
    data, gamma, beta = inputs
    eps = float(attrs.get('eps', 1e-3))
    axes = tuple(range(2, data.ndim))
    # jnp.mean / jnp.var reduce a bf16 input in f32 and return bf16
    x32 = data.float()
    mean = torch.mean(x32, dim=axes, keepdim=True).to(data.dtype)
    var = torch.var(x32, dim=axes, unbiased=False,
                    keepdim=True).to(data.dtype)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return [out * gamma.reshape(bshape) + beta.reshape(bshape)], {}


register('InstanceNorm', _instance_norm_apply,
         input_names=lambda attrs: ['data', 'gamma', 'beta'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_bn_complete,
         attr_defaults={'eps': 1e-3}, hint='instancenorm')


# ---------------------------------------------------------------------------
# L2Normalization (l2_normalization-inl.h) and LRN (lrn-inl.h)
# ---------------------------------------------------------------------------

def _l2_normalization(x, eps=1e-10, mode='instance'):
    if mode == 'instance':
        norm = torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                    dim=1) + eps)
        return x / norm.reshape((-1,) + (1,) * (x.ndim - 1))
    if mode == 'channel':
        return x / torch.sqrt(torch.sum(torch.square(x), dim=1,
                                        keepdim=True) + eps)
    if mode == 'spatial':
        axes = tuple(range(2, x.ndim))
        return x / torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                        keepdim=True) + eps)
    raise ValueError('L2Normalization: unknown mode %r' % (mode,))


register_simple('L2Normalization', _l2_normalization,
                attr_defaults={'eps': 1e-10, 'mode': 'instance'},
                hint='l2normalization')


def _lrn(x, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """``x / (knorm + alpha / nsize * sum of x^2 over a window of nsize
    channels, zero beyond the edges) ** beta``."""
    nsize = int(nsize)
    half = nsize // 2
    channels = x.shape[1]
    sq = F.pad(torch.square(x), [0, 0] * (x.ndim - 2) + [half, half])
    ssum = sq.narrow(1, 0, channels)
    for j in range(1, nsize):
        ssum = ssum + sq.narrow(1, j, channels)
    return x / torch.pow(knorm + (alpha / nsize) * ssum, beta)


register_simple('LRN', _lrn,
                attr_defaults={'nsize': 5, 'alpha': 1e-4, 'beta': 0.75,
                               'knorm': 2.0}, hint='lrn')


# ---------------------------------------------------------------------------
# Dropout (dropout-inl.h) — scaled inverted dropout, identity at eval;
# Concat
# ---------------------------------------------------------------------------

def _dropout_apply(attrs, inputs, is_train, rng):
    p = float(attrs.get('p', 0.5))
    data = inputs[0]
    if not is_train or p <= 0.0:
        return [data], {}
    keep = 1.0 - p
    mask = _uniform_like(data.float(), 0.0, 1.0) < keep
    return [torch.where(mask, data / keep, torch.zeros_like(data))
            .to(data.dtype)], {}


register('Dropout', _dropout_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: 1,
         takes_rng=True,
         attr_defaults={'p': 0.5}, hint='dropout')


def _concat_apply(attrs, inputs, is_train, rng):
    return [torch.cat(list(inputs), dim=int(attrs.get('dim', 1)))], {}


register('Concat', _concat_apply,
         input_names=lambda attrs: ['arg%d' % i for i in
                                    range(int(attrs.get('num_args', 1)))],
         num_outputs=lambda attrs: 1,
         attr_defaults={'num_args': 1, 'dim': 1}, hint='concat')
alias('concat', 'Concat')


# ---------------------------------------------------------------------------
# SliceChannel / split, Embedding
# ---------------------------------------------------------------------------

def _slice_channel_apply(attrs, inputs, is_train, rng):
    num = int(attrs.get('num_outputs', 1))
    axis = int(attrs.get('axis', 1))
    data = inputs[0]
    if data.shape[axis] % num:
        raise ValueError('SliceChannel: axis %d of size %d does not split '
                         'into %d equal parts'
                         % (axis, data.shape[axis], num))
    parts = torch.split(data, data.shape[axis] // num, dim=axis)
    if bool(attrs.get('squeeze_axis', False)):
        parts = [p.squeeze(axis) for p in parts]
    return list(parts), {}


register('SliceChannel', _slice_channel_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: int(attrs.get('num_outputs', 1)),
         attr_defaults={'num_outputs': 1, 'axis': 1, 'squeeze_axis': False},
         hint='slicechannel')
alias('split', 'SliceChannel')


def _embedding_apply(attrs, inputs, is_train, rng):
    # ids arrive as floats, truncated as astype(int32) does, and are read
    # as jnp.take reads them (ops/tensor.py fill_index): -1 wraps to the
    # last row, an id outside [-V, V) gives a NaN row and no gradient;
    # the weight gradient is the scatter-add of the kept rows' gradients
    from .tensor import fill_index
    data, weight = inputs
    index, kept = fill_index(data.long(), weight.shape[0])
    rows = F.embedding(index, weight)
    return [rows.masked_fill(~kept[..., None], float('nan'))], {}


def _embedding_complete(attrs, in_shapes):
    _complete(in_shapes, 1, (int(attrs['input_dim']),
                             int(attrs['output_dim'])))
    return in_shapes


register('Embedding', _embedding_apply,
         input_names=lambda attrs: ['data', 'weight'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_embedding_complete,
         attr_defaults={'dtype': 'float32'}, hint='embedding')


# ---------------------------------------------------------------------------
# UpSampling (upsampling-inl.h) and Crop (crop-inl.h)
# ---------------------------------------------------------------------------

def _upsampling_apply(attrs, inputs, is_train, rng):
    # as the JAX op: only the first input is upsampled (ROADMAP Queue 3)
    scale = int(attrs.get('scale', 2))
    data = inputs[0]
    if attrs.get('sample_type', 'nearest') == 'nearest':
        out = torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    else:
        # half-pixel centres, the edge pixel repeated: jax.image.resize's
        # 'bilinear' when it enlarges
        out = F.interpolate(data, scale_factor=scale, mode='bilinear',
                            align_corners=False)
    return [out], {}


register('UpSampling', _upsampling_apply,
         input_names=lambda attrs: ['arg%d' % i for i in
                                    range(int(attrs.get('num_args', 1)))],
         num_outputs=lambda attrs: 1,
         attr_defaults={'num_args': 1, 'scale': 2, 'sample_type': 'nearest',
                        'num_filter': 0}, hint='upsampling')


def _crop_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    offset = _tup(attrs.get('offset'), 2, default=0)
    if len(inputs) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = _tup(attrs['h_w'], 2)
    h, w = data.shape[2], data.shape[3]
    if bool(attrs.get('center_crop', False)):
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = offset
    return [data[:, :, y0:y0 + th, x0:x0 + tw]], {}


register('Crop', _crop_apply,
         input_names=lambda attrs: (['data', 'crop_like']
                                    if int(attrs.get('num_args', 1)) == 2
                                    else ['data']),
         num_outputs=lambda attrs: 1,
         attr_defaults={'num_args': 1, 'offset': (0, 0), 'h_w': (0, 0),
                        'center_crop': False}, hint='crop')


# ---------------------------------------------------------------------------
# Sequence ops (sequence_last/mask/reverse-inl.h), layout (T, N, ...)
# ---------------------------------------------------------------------------

def _lengths(inputs, attrs, t, n, device):
    if bool(attrs.get('use_sequence_length', False)) and len(inputs) > 1:
        return inputs[1].to(torch.int64)
    return torch.full((n,), t, dtype=torch.int64, device=device)


def _along_time(index, data):
    """``index`` (rows, N) broadcast over data's trailing dims, for a
    gather along dim 0."""
    return index.reshape(index.shape + (1,) * (data.ndim - 2)).expand(
        (index.shape[0],) + tuple(data.shape[1:]))


def _sequence_last_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    t, n = data.shape[0], data.shape[1]
    idx = torch.clamp(_lengths(inputs, attrs, t, n, data.device) - 1, 0,
                      t - 1)
    return [torch.gather(data, 0, _along_time(idx[None], data))[0]], {}


def _sequence_mask_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    t, n = data.shape[0], data.shape[1]
    lengths = _lengths(inputs, attrs, t, n, data.device)
    keep = torch.arange(t, device=data.device)[:, None] < lengths[None, :]
    keep = keep.reshape((t, n) + (1,) * (data.ndim - 2))
    value = torch.full((), float(attrs.get('value', 0.0)), dtype=data.dtype,
                       device=data.device)
    return [torch.where(keep, data, value)], {}


def _sequence_reverse_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    t, n = data.shape[0], data.shape[1]
    lengths = _lengths(inputs, attrs, t, n, data.device)[None, :]
    steps = torch.arange(t, device=data.device)[:, None]
    src = torch.where(steps < lengths, lengths - 1 - steps, steps)
    return [torch.gather(data, 0, _along_time(src, data))], {}


for _name, _fn in (('SequenceLast', _sequence_last_apply),
                   ('SequenceMask', _sequence_mask_apply),
                   ('SequenceReverse', _sequence_reverse_apply)):
    register(_name, _fn,
             input_names=lambda attrs: (
                 ['data', 'sequence_length']
                 if attrs.get('use_sequence_length', False) else ['data']),
             num_outputs=lambda attrs: 1,
             attr_defaults={'use_sequence_length': False, 'value': 0.0},
             hint=_name.lower())


def _softmax_cross_entropy(data, label):
    from .tensor import _one_hot
    hot = _one_hot(label, data.shape[-1], dtype=data.dtype)
    return -torch.sum(torch.log_softmax(data, dim=-1) * hot,
                      dim=-1).sum().reshape((1,))


register_simple('softmax_cross_entropy', _softmax_cross_entropy, ninputs=2,
                input_names=['data', 'label'])


# ---------------------------------------------------------------------------
# FlashAttention — the symbol-level door to the flash-attention kernel
# (ops/attention.py).  Inside a sequence-parallel scope (parallel/sp.py)
# the node runs ring or Ulysses attention over the scope's process group.
# ---------------------------------------------------------------------------

def _flash_attention_apply(attrs, inputs, is_train, rng):
    from .attention import flash_attention
    from ..parallel.sp import current_sp_axis, current_sp_mode
    q, k, v = inputs
    causal = bool(attrs.get('causal', False))
    scale = attrs.get('scale')
    group = current_sp_axis()
    if group is not None:
        from ..parallel.ring import ring_attention, ulysses_attention
        if scale is not None:
            # the sharded forms use 1/sqrt(D): a custom scale goes into q
            q = q * (float(scale) * (q.shape[-1] ** 0.5))
        attend = ulysses_attention if current_sp_mode() == 'ulysses' \
            else ring_attention
        return [attend(q, k, v, group, causal=causal)], {}
    return [flash_attention(q, k, v, causal=causal,
                            scale=None if scale is None else float(scale))], {}


def _flash_attention_complete(attrs, in_shapes):
    q = in_shapes[0]
    if q is not None:
        for i in (1, 2):
            if in_shapes[i] is None:
                in_shapes[i] = tuple(q)
    return in_shapes


register('FlashAttention', _flash_attention_apply,
         input_names=lambda attrs: ['query', 'key', 'value'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_flash_attention_complete,
         attr_defaults={'causal': False, 'scale': None},
         hint='attention')
