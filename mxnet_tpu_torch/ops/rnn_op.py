"""Fused multi-layer RNN operator — the port of ``mxnet_tpu/ops/rnn_op.py``
(the reference's cuDNN RNN, ``src/operator/cudnn_rnn-inl.h``).

The JAX op runs each layer and direction as a ``lax.scan`` over time; no
Pallas kernel is involved.  Here the whole stack is one call of torch's
fused RNN (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``):
cuDNN on the card, torch's own loop on the CPU.

Packed parameter layout (the same blob in both packages, so checkpoints
and ``FusedRNNCell.pack_weights`` interchange): for each layer, for each
direction, ``W`` (gates*H, input_size) then ``R`` (gates*H, H); then for
each layer and direction ``bW`` (gates*H,) and ``bR`` (gates*H,).  Gate
order LSTM i,f,g,o and GRU r,z,n, with GRU's ``r`` applied to
``(R_n h + b_Rn)``: torch's order and formula too.  The blob is sliced
into torch's ``(w_ih, w_hh, b_ih, b_hh)`` per layer and direction as
views (no copy), so gradients reach the blob through autograd.

Inter-layer dropout (``p``) draws from the port's per-device generator
(``random.py``): with ``p > 0`` in training the layers run one call each
with the mask applied between them.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ['rnn_param_layout', 'rnn_param_size']

_GATES = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}


def rnn_param_layout(mode, input_size, state_size, num_layers,
                     bidirectional=False):
    """Return ([(name, shape, offset)], total) describing the packed
    blob (``mxnet_tpu/ops/rnn_op.py:28``)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    specs = []
    offset = 0
    for layer in range(num_layers):
        isize = input_size if layer == 0 else state_size * dirs
        for d in range(dirs):
            prefix = '%s%d' % ('r' if d else 'l', layer)
            for nm, shape in [('i2h_weight', (gates * state_size, isize)),
                              ('h2h_weight', (gates * state_size, state_size))]:
                specs.append(('%s_%s' % (prefix, nm), shape, offset))
                offset += math.prod(shape)
    for layer in range(num_layers):
        for d in range(dirs):
            prefix = '%s%d' % ('r' if d else 'l', layer)
            for nm in ['i2h_bias', 'h2h_bias']:
                shape = (gates * state_size,)
                specs.append(('%s_%s' % (prefix, nm), shape, offset))
                offset += math.prod(shape)
    return specs, offset


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional=False):
    return rnn_param_layout(mode, input_size, state_size, num_layers,
                            bidirectional)[1]


def _torch_weights(params, mode, input_size, state_size, num_layers,
                   dirs, layers):
    """Views of the blob in torch's flat-weight order for ``layers``:
    per layer, per direction, ``[w_ih, w_hh, b_ih, b_hh]``."""
    specs, _ = rnn_param_layout(mode, input_size, state_size, num_layers,
                                dirs == 2)
    views = {name: params[off:off + math.prod(shape)].view(shape)
             for name, shape, off in specs}
    flat = []
    for layer in layers:
        for d in range(dirs):
            p = '%s%d_' % ('r' if d else 'l', layer)
            flat += [views[p + 'i2h_weight'], views[p + 'h2h_weight'],
                     views[p + 'i2h_bias'], views[p + 'h2h_bias']]
    return flat


def _run(mode, x, h0, c0, weights, num_layers, dirs, is_train):
    """One fused call over ``num_layers`` layers; returns (out, hT, cT)."""
    fn = getattr(torch._VF, mode)
    if mode == 'lstm':
        out, h, c = fn(x, (h0, c0), weights, True, num_layers, 0.0,
                       bool(is_train), dirs == 2, False)
        return out, h, c
    out, h = fn(x, h0, weights, True, num_layers, 0.0, bool(is_train),
                dirs == 2, False)
    return out, h, None


def _rnn_apply(attrs, inputs, is_train, rng):
    mode = attrs.get('mode', 'lstm')
    state_size = int(attrs['state_size'])
    num_layers = int(attrs['num_layers'])
    dirs = 2 if bool(attrs.get('bidirectional', False)) else 1
    p = float(attrs.get('p', 0.0))
    state_outputs = bool(attrs.get('state_outputs', False))
    data, params = inputs[0], inputs[1]
    t, n, input_size = data.shape
    if bool(attrs.get('use_state', False)):
        state = inputs[2]
        state_cell = inputs[3] if mode == 'lstm' else None
    else:
        state = data.new_zeros((num_layers * dirs, n, state_size))
        state_cell = state if mode == 'lstm' else None
    if data.device.type == 'meta':
        # shape inference: torch's fused RNN has no meta kernel
        outs = [data.new_empty((t, n, state_size * dirs))]
        if state_outputs:
            outs += [data.new_empty(state.shape)] * (2 if mode == 'lstm'
                                                     else 1)
        return outs, {}
    if not (is_train and p > 0.0 and num_layers > 1):
        weights = _torch_weights(params, mode, input_size, state_size,
                                 num_layers, dirs, range(num_layers))
        x, h, c = _run(mode, data, state, state_cell, weights, num_layers,
                       dirs, is_train)
    else:
        from ..random import generator
        x, hs, cs = data, [], []
        keep = 1.0 - p
        for layer in range(num_layers):
            rows = slice(layer * dirs, (layer + 1) * dirs)
            weights = _torch_weights(params, mode, input_size, state_size,
                                     num_layers, dirs, (layer,))
            c0 = None if state_cell is None else \
                state_cell[rows].contiguous()
            x, h, c = _run(mode, x, state[rows].contiguous(), c0, weights,
                           1, dirs, is_train)
            hs.append(h)
            cs.append(c)
            if layer + 1 < num_layers:
                u = torch.empty(x.shape, device=x.device).uniform_(
                    0.0, 1.0, generator=generator(x.device))
                x = torch.where(u < keep, x / keep,
                                torch.zeros_like(x)).to(x.dtype)
        h = torch.cat(hs)
        c = torch.cat(cs) if mode == 'lstm' else None
    outputs = [x]
    if state_outputs:
        outputs.append(h)
        if mode == 'lstm':
            outputs.append(c)
    return outputs, {}


def _rnn_complete(attrs, in_shapes):
    mode = attrs.get('mode', 'lstm')
    state_size = int(attrs['state_size'])
    num_layers = int(attrs['num_layers'])
    bidirectional = bool(attrs.get('bidirectional', False))
    dirs = 2 if bidirectional else 1
    data_shape = in_shapes[0]
    if data_shape is not None:
        _, n, input_size = data_shape
        if in_shapes[1] is None:
            in_shapes[1] = (rnn_param_size(mode, input_size, state_size,
                                           num_layers, bidirectional),)
        if len(in_shapes) > 2 and in_shapes[2] is None:
            in_shapes[2] = (num_layers * dirs, n, state_size)
        if mode == 'lstm' and len(in_shapes) > 3 and in_shapes[3] is None:
            in_shapes[3] = (num_layers * dirs, n, state_size)
    return in_shapes


def _rnn_input_names(attrs):
    names = ['data', 'parameters']
    if attrs.get('use_state', False):
        names.append('state')
        if attrs.get('mode', 'lstm') == 'lstm':
            names.append('state_cell')
    return names


def _rnn_num_outputs(attrs):
    if not attrs.get('state_outputs', False):
        return 1
    return 3 if attrs.get('mode', 'lstm') == 'lstm' else 2


register('RNN', _rnn_apply,
         input_names=_rnn_input_names,
         num_outputs=_rnn_num_outputs,
         complete_shapes=_rnn_complete,
         takes_rng=True,
         attr_defaults={'mode': 'lstm', 'bidirectional': False, 'p': 0.0,
                        'state_outputs': False, 'use_state': False,
                        'lstm_state_clip_min': None,
                        'lstm_state_clip_max': None},
         hint='rnn')
