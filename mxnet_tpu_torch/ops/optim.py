"""Optimizer-update operators — the port of ``mxnet_tpu/ops/optim.py``
(``:19-70``; the reference's ``src/operator/optimizer_op.cc:18-42``):
``sgd_update``, ``sgd_mom_update``, ``adam_update``, ``rmsprop_update``
and ``rmspropalex_update``.

Weight, gradient and state come in; the updated weight and state come
out, in that order.  ``clip_gradient < 0`` means no clipping.  Through
the imperative layer (``nd.sgd_mom_update(w, g, mom, out=[w, mom])``,
``imperative_invoke``) the results are written into the tensors of the
``out`` arrays (``OpDef.out_in_place``), which is how the optimizers'
``update`` writes the weight and state an ``Updater`` holds.  The
arithmetic is plain PyTorch, as the reference's is plain ``jnp``: these
ops have no TPU kernel.

The reference passes the rates and decays (lr, wd, rescale_grad, the
momenta, betas, gammas and epsilon) into its jitted op as float32
scalars, so ``1 - beta`` is a float32 difference there; the same
arithmetic here keeps the two packages' updates equal.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_simple


def _f32(*values):
    """Each value rounded to float32, as a Python float."""
    return [float(np.float32(v)) for v in values]


def _one_minus(v):
    """``1 - v`` computed in float32."""
    return float(np.float32(1.0) - np.float32(v))


def _rescale_clip(grad, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    return grad


def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    lr, wd, rescale_grad = _f32(lr, wd, rescale_grad)
    grad = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (grad + wd * weight)


def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    lr, momentum, wd, rescale_grad = _f32(lr, momentum, wd, rescale_grad)
    grad = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * (grad + wd * weight)
    return weight + mom, mom


def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    c1, c2 = _one_minus(beta1), _one_minus(beta2)
    lr, beta1, beta2, epsilon, wd, rescale_grad = _f32(
        lr, beta1, beta2, epsilon, wd, rescale_grad)
    grad = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    mean = beta1 * mean + c1 * grad
    var = beta2 * var + c2 * torch.square(grad)
    weight = weight - lr * mean / (torch.sqrt(var) + epsilon)
    return weight, mean, var


def _clip_weights(weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        weight = torch.clamp(weight, -clip_weights, clip_weights)
    return weight


def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    c1 = _one_minus(gamma1)
    lr, gamma1, epsilon, wd, rescale_grad = _f32(lr, gamma1, epsilon, wd,
                                                 rescale_grad)
    grad = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    n = c1 * torch.square(grad) + gamma1 * n
    weight = weight - lr * grad / torch.sqrt(n + epsilon)
    return _clip_weights(weight, clip_weights), n


def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.9,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    c1 = _one_minus(gamma1)
    lr, gamma1, gamma2, epsilon, wd, rescale_grad = _f32(
        lr, gamma1, gamma2, epsilon, wd, rescale_grad)
    grad = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    n = c1 * torch.square(grad) + gamma1 * n
    g = c1 * grad + gamma1 * g
    delta = gamma2 * delta - lr * grad / torch.sqrt(
        n - torch.square(g) + epsilon)
    weight = weight + delta
    return _clip_weights(weight, clip_weights), n, g, delta


register_simple('sgd_update', _sgd_update, ninputs=2,
                input_names=['weight', 'grad'], out_in_place=True,
                attr_defaults={'lr': 0.01, 'wd': 0.0, 'rescale_grad': 1.0,
                               'clip_gradient': -1.0})
register_simple('sgd_mom_update', _sgd_mom_update, ninputs=3, noutputs=2,
                input_names=['weight', 'grad', 'mom'], out_in_place=True,
                attr_defaults={'lr': 0.01, 'momentum': 0.0, 'wd': 0.0,
                               'rescale_grad': 1.0, 'clip_gradient': -1.0})
register_simple('adam_update', _adam_update, ninputs=4, noutputs=3,
                input_names=['weight', 'grad', 'mean', 'var'],
                out_in_place=True,
                attr_defaults={'lr': 0.001, 'beta1': 0.9, 'beta2': 0.999,
                               'epsilon': 1e-8, 'wd': 0.0, 'rescale_grad': 1.0,
                               'clip_gradient': -1.0})
register_simple('rmsprop_update', _rmsprop_update, ninputs=3, noutputs=2,
                input_names=['weight', 'grad', 'n'], out_in_place=True,
                attr_defaults={'lr': 0.001, 'gamma1': 0.9, 'epsilon': 1e-8,
                               'wd': 0.0, 'rescale_grad': 1.0,
                               'clip_gradient': -1.0, 'clip_weights': -1.0})
register_simple('rmspropalex_update', _rmspropalex_update, ninputs=5,
                noutputs=4, out_in_place=True,
                input_names=['weight', 'grad', 'n', 'g', 'delta'],
                attr_defaults={'lr': 0.001, 'gamma1': 0.9, 'gamma2': 0.9,
                               'epsilon': 1e-8, 'wd': 0.0, 'rescale_grad': 1.0,
                               'clip_gradient': -1.0, 'clip_weights': -1.0})
