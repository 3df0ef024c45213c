"""CTC loss — the port of ``mxnet_tpu/ops/ctc.py`` (reference WarpCTC
plugin, ``plugin/warpctc/warpctc-inl.h``).

The forward (alpha) recursion runs in log space as a loop over time
(the JAX op's ``lax.scan``), batched over the samples; its gradient with
respect to the activations comes from autograd through the loop, as the
JAX op's ``ctc_grad`` comes from ``jax.grad`` through the scan.

- ``ctc_loss``: data ``(T, N, C)``, labels ``(N, L)`` 0-padded, optional
  per-sample data and label lengths; the per-sample loss ``(N,)``.
- ``WarpCTC``: data ``((T*N), C)``, flat labels, attrs ``label_length``
  and ``input_length``; the forward output is the softmax of the
  activations and the backward injects the CTC gradient (times
  ``grad_scale``), ignoring the head gradient like the other loss layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ['ctc_neg_log_prob', 'ctc_grad']

_NEG_INF = -1e30


def _extend_labels(labels, blank):
    """(N, L) -> (N, 2L+1) with blanks interleaved: b l0 b l1 ... b."""
    n, l = labels.shape
    ext = torch.full((n, 2 * l + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def ctc_neg_log_prob(logits, labels, data_lengths=None, label_lengths=None,
                     blank=0):
    """Per-sample negative log likelihood of ``labels`` under CTC
    (``mxnet_tpu/ops/ctc.py:41``).  logits: (T, N, C) raw activations;
    labels: (N, L), 0-padded (entries equal to ``blank`` beyond the true
    length are padding)."""
    t_max, n, _ = logits.shape
    dev = logits.device
    labels = labels.to(torch.int64)
    if data_lengths is None:
        data_lengths = torch.full((n,), t_max, dtype=torch.int64, device=dev)
    if label_lengths is None:
        label_lengths = torch.sum((labels != blank).to(torch.int64), dim=1)
    data_lengths = data_lengths.to(torch.int64)
    label_lengths = label_lengths.to(torch.int64)

    log_probs = torch.log_softmax(logits.float(), dim=-1)
    ext = _extend_labels(labels, blank)              # (N, S)
    s = ext.shape[1]
    # the skip edge s-2 -> s: the symbol is not blank and differs from
    # the symbol two back
    skip_ok = torch.cat(
        [torch.zeros((n, 2), dtype=torch.bool, device=dev),
         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    pos = torch.arange(s, device=dev)[None, :]
    emit0 = torch.gather(log_probs[0], 1, ext)
    alpha = torch.where(pos <= 1, emit0, _NEG_INF)
    # samples with zero-length labels can only sit in state 0
    alpha = torch.where((label_lengths[:, None] == 0) & (pos > 0),
                        _NEG_INF, alpha)
    for t in range(1, t_max):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG_INF)
        prev2 = F.pad(alpha[:, :-2], (2, 0), value=_NEG_INF)
        prev2 = torch.where(skip_ok, prev2, _NEG_INF)
        tot = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = tot + torch.gather(log_probs[t], 1, ext)
        # frozen beyond each sample's input length
        alpha = torch.where(t < data_lengths[:, None], new, alpha)

    # final states: the trailing blank and the last symbol
    last = 2 * label_lengths
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 1, min=0)[:, None])
    a_prev = torch.where(label_lengths > 0, a_prev[:, 0], _NEG_INF)
    return -torch.logaddexp(a_last, a_prev)


def ctc_grad(logits, labels, data_lengths=None, label_lengths=None,
             blank=0):
    """d(sum of per-sample NLL)/d(logits) — the warp-ctc gradient
    (``mxnet_tpu/ops/ctc.py:102``)."""
    with torch.enable_grad():
        lg = logits.detach().requires_grad_(True)
        total = torch.sum(ctc_neg_log_prob(lg, labels, data_lengths,
                                           label_lengths, blank))
        grad, = torch.autograd.grad(total, lg)
    return grad


# ---------------------------------------------------------------------------
# op registrations
# ---------------------------------------------------------------------------

def _ctc_loss_apply(attrs, inputs, is_train, rng):
    data, label = inputs[0], inputs[1]
    blank = int(attrs.get('blank_label', 0))
    k = 2
    dlen = llen = None
    if bool(attrs.get('use_data_lengths', False)):
        dlen = inputs[k]
        k += 1
    if bool(attrs.get('use_label_lengths', False)):
        llen = inputs[k]
    if data.device.type == 'meta':
        return [data.new_empty((data.shape[1],))], {}
    loss = ctc_neg_log_prob(data, label, dlen, llen, blank)
    return [loss.to(data.dtype)], {}


def _ctc_loss_inputs(attrs):
    names = ['data', 'label']
    if bool(attrs.get('use_data_lengths', False)):
        names.append('data_lengths')
    if bool(attrs.get('use_label_lengths', False)):
        names.append('label_lengths')
    return names


register('ctc_loss', _ctc_loss_apply,
         input_names=_ctc_loss_inputs,
         num_outputs=lambda attrs: 1,
         attr_defaults={'use_data_lengths': False,
                        'use_label_lengths': False, 'blank_label': 0},
         hint='ctc_loss')


class _WarpCTCFn(torch.autograd.Function):
    """softmax forward; backward = the CTC gradient of the activations
    (rows t*N + n, time-major), scaled, the head gradient ignored."""

    @staticmethod
    def forward(ctx, data, label, input_length, label_length, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.dims = (input_length, label_length, grad_scale)
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        input_length, label_length, grad_scale = ctx.dims
        tn, c = data.shape
        n = tn // input_length
        grad = ctc_grad(data.reshape(input_length, n, c),
                        label.reshape(n, label_length), blank=0)
        grad = grad.reshape(tn, c) * grad_scale
        return (grad.to(data.dtype), torch.zeros_like(label), None, None,
                None)


def _warpctc_apply(attrs, inputs, is_train, rng):
    data, label = inputs[0], inputs[1]
    label_length = int(attrs['label_length'])
    input_length = int(attrs['input_length'])
    grad_scale = float(attrs.get('grad_scale', 1.0))
    if data.ndim != 2:
        raise ValueError(
            'WarpCTC expects 2-D data of shape (input_length*batch, '
            'alphabet); got shape %s' % (tuple(data.shape),))
    tn, _ = data.shape
    if tn % input_length != 0:
        raise ValueError(
            'WarpCTC: data rows (%d) are not a multiple of input_length '
            '(%d); data must be laid out (input_length*batch, alphabet) '
            'as in the reference plugin (plugin/warpctc/warpctc-inl.h)'
            % (tn, input_length))
    n = tn // input_length
    if math.prod(label.shape) != n * label_length:
        raise ValueError(
            'WarpCTC: label size %d does not match batch*label_length '
            '= %d*%d' % (math.prod(label.shape), n, label_length))
    return [_WarpCTCFn.apply(data, label, input_length, label_length,
                             grad_scale)], {}


def _warpctc_complete(attrs, in_shapes):
    if in_shapes[0] is not None and in_shapes[1] is None:
        input_length = int(attrs['input_length'])
        label_length = int(attrs['label_length'])
        n = in_shapes[0][0] // input_length
        in_shapes[1] = (n * label_length,)
    return in_shapes


register('WarpCTC', _warpctc_apply,
         input_names=lambda attrs: ['data', 'label'],
         num_outputs=lambda attrs: 1,
         complete_shapes=_warpctc_complete,
         attr_defaults={'grad_scale': 1.0},
         hint='warpctc')
