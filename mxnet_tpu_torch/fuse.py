"""The step compiler — a sequenced, knob-gated graph-rewrite pipeline.

The port of ``mxnet_tpu/fuse.py``: the same :class:`PassManager`, the
same passes in the same order (``default_passes``, ``:1098-1112``), the
same fused node names and the same ``MXTPU_FUSE=off|safe|aggressive`` /
``MXTPU_FUSE_SKIP`` knobs, so a graph leaves this pipeline exactly as it
leaves the JAX one.

==================  ==========  =============================================
pass                level       rewrite
==================  ==========  =============================================
``constant_fold``   safe        constant subgraphs (``_zeros`` / ``_ones`` /
                                ``_full`` / ``_arange`` rooted) pre-evaluated
                                into ``_graph_constant`` nodes
``dead_branch``     safe        elide identity nodes; drop unconsumed
                                BatchNorm mean/var heads
``conv_bn_fold``    aggressive  Convolution->BatchNorm folded into the conv
                                weights (inference; training on moving stats)
``bn_relu_conv``    aggressive  BN->relu->conv into ``_bn_relu_conv`` nodes,
                                lowered onto ``fused_scale_bias_dot`` (1x1,
                                ops/fused.py) and ``fused_scale_bias_conv3x3``
                                (3x3, ops/fused_conv.py)
``bn_relu``         aggressive  leftover BN->relu chains onto the
                                ``fused_bn_relu`` kernel (ops/fused.py)
``epilogue``        safe        bias-add/relu/clip chains after Conv/FC
                                collapsed into the producer (exact replay);
                                under aggressive a FullyConnected chain
                                ``[bias-add] [relu] [clip]`` is lowered
                                onto ``fused_dot_epilogue`` (ops/fused.py)
``nhwc_regions``    aggressive  channels-last regions around
                                ``_bn_relu_conv`` (explicit ``transpose``
                                nodes only at region boundaries)
==================  ==========  =============================================

The JAX package runs ``bn_relu_conv`` and ``nhwc_regions``, and lowers
the aggressive epilogue onto its kernel, only where its Pallas kernels
are live (a TPU, or the Pallas interpreter forced:
``mxnet_tpu/fuse.py:1071-1095``, ``:916``); on its plain-XLA path they
step aside.  The port's kernels are always live — the CUDA kernel on the
card, the plain version on the CPU — so the port runs both passes and
the lowering whenever the mode is ``aggressive`` and builds and computes
the graph the JAX package builds on a TPU or in interpret mode.

On ResNet-50 v2 inference ``conv_bn_fold`` takes every conv->BN pair, so
``bn_relu_conv`` finds nothing and ``bn_relu`` lowers the 17 remaining
BN->relu chains; in training the live batch statistics keep the BNs
unfolded and ``bn_relu_conv`` rewrites 52 of the 53 convs.  In the
transformer LM each block's FFN ``FullyConnected -> relu`` is the one
chain the epilogue pass takes.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import as_torch_device
from .ops.fused import (fused_bn_relu, fused_dot_epilogue,
                        fused_scale_bias_dot)
from .ops.fused_conv import fused_scale_bias_conv3x3
from .ops.nn import _conv_apply, batch_norm_stats
from .ops.registry import get_op, register
from .symbol import Node, Symbol

__all__ = ['fold_conv_bn', 'fold_constants', 'prune_dead_branches',
           'fuse_bn_relu', 'fuse_epilogues', 'FusePass', 'PassManager',
           'default_passes', 'default_manager', 'fuse_mode',
           'apply_fuse_passes', 'last_run_stats']


def _tup_or(v, default):
    if v is None or v == ():
        return default
    if isinstance(v, int):
        return (v, v)
    return tuple(int(x) for x in v)


def _bn_scale_bias(attrs, data, gamma, beta, mov_mean, mov_var,
                   is_train, axes=(0, 2, 3)):
    """The BN stats step folded to per-channel (scale, bias) in the data
    dtype; the statistics come from ``batch_norm_stats`` (ops/nn.py), so
    fused and unfused numerics cannot drift."""
    eps = float(attrs.get('eps', 1e-3))
    momentum = float(attrs.get('momentum', 0.9))
    g = torch.ones_like(gamma) if bool(attrs.get('fix_gamma', True)) \
        else gamma
    mean, var, aux_updates = batch_norm_stats(
        data, mov_mean, mov_var, axes, momentum,
        is_train and not bool(attrs.get('use_global_stats', False)))
    scale = (g * torch.rsqrt(var + eps)).to(data.dtype)
    bias = (beta - mean * scale).to(data.dtype)
    return scale, bias, aux_updates


def _rewrite(sym: Symbol, try_fuse) -> Symbol:
    """Shared graph-rewrite scaffolding: walk topo order, let
    ``try_fuse(node, consumer_list, mapped_entry)`` return a
    replacement Node (or None to copy verbatim), rebuild the Symbol."""
    nodes = sym.topo_nodes()
    consumers = {}
    for n in nodes:
        for inp in n.inputs:
            consumers.setdefault((id(inp[0]), inp[1]), []).append(n)
    for entry in sym._outputs:
        # a graph output counts as a consumer
        consumers.setdefault((id(entry[0]), entry[1]), []).append(None)

    def consumer_list(node, idx=0):
        return consumers.get((id(node), idx), [])

    mapping = {}

    def mapped_entry(entry):
        return (mapping[id(entry[0])], entry[1])

    for n in nodes:
        if n.is_variable:
            mapping[id(n)] = n
            continue
        fused = try_fuse(n, consumer_list, mapped_entry)
        if fused is None:
            fused = Node(n.op, n.name, n.attrs,
                         [mapped_entry(e) for e in n.inputs])
            fused._extra_attr = n._extra_attr
        mapping[id(n)] = fused
    return Symbol([mapped_entry(e) for e in sym._outputs])


def _rewrite_counted(sym: Symbol, try_fuse):
    """:func:`_rewrite` returning ``(sym, rewrites)``; no rewrite hands
    back the ORIGINAL symbol object."""
    cell = [0]

    def counting(n, consumer_list, mapped_entry):
        fused = try_fuse(n, consumer_list, mapped_entry)
        if fused is not None:
            cell[0] += 1
        return fused

    out = _rewrite(sym, counting)
    if cell[0] == 0:
        return sym, 0
    return out, cell[0]


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

# ops that generate a constant from attrs alone (the fold frontier);
# any rng-free, aux-free node all of whose inputs are constant extends it
_CONST_LEAF_OPS = ('_zeros', '_ones', '_full', '_arange')
# never embed constants past this size (the JAX pass's cap)
_CONST_FOLD_MAX_ELEMS = 65536


def _graph_constant_apply(attrs, inputs, is_train, rng):
    # the value rides attrs as nested lists (JSON-able, as in the JAX
    # pass); made on the device the graph runs on
    arr = np.array(attrs['value'], dtype=attrs['dtype']).reshape(
        tuple(attrs['shape']))
    return [torch.from_numpy(arr).to(as_torch_device(attrs.get('ctx')))], {}


register('_graph_constant', _graph_constant_apply,
         input_names=lambda a: [], num_outputs=lambda a: 1,
         hint='graph_constant')


def _const_value(node):
    return np.array(node.attrs['value'], dtype=node.attrs['dtype']).reshape(
        tuple(node.attrs['shape']))


def fold_constants(sym: Symbol, is_train=False, mode='safe'):
    """Pre-evaluate constant subgraphs (rooted at ``_zeros`` / ``_ones`` /
    ``_full`` / ``_arange``) at pass time, on the CPU, and splice the
    results in as ``_graph_constant`` nodes (``mxnet_tpu/fuse.py:
    565-682``).  Only rng-free, aux-free, exception-free nodes whose
    inputs are all constant fold, and results above
    ``_CONST_FOLD_MAX_ELEMS`` elements stay symbolic.  Returns
    ``(symbol, constants materialized)``."""
    nodes = sym.topo_nodes()
    vals = {}           # id(node) -> list of numpy outputs
    cpu = torch.device('cpu')
    for node in nodes:
        if node.is_variable:
            continue
        if node.op == '_graph_constant':
            vals[id(node)] = [_const_value(node)]
            continue
        op = node.opdef()
        if op.takes_rng or op.aux_names(node.attrs):
            continue
        attrs = node.attrs
        if node.inputs:
            if not all(id(s) in vals for s, _ in node.inputs):
                continue
            ins = [torch.from_numpy(vals[id(s)][j]) for s, j in node.inputs]
        elif node.op in _CONST_LEAF_OPS:
            ins = []
            attrs = dict(attrs, ctx=cpu)
        else:
            continue
        try:
            with torch.no_grad():
                outs, aux = op.apply(attrs, ins, False, None)
            outs = [o.detach().cpu().numpy() for o in outs]
        except Exception:           # noqa: BLE001 - the node stays symbolic
            continue
        if aux or any(o.size > _CONST_FOLD_MAX_ELEMS for o in outs):
            continue
        vals[id(node)] = outs

    if not vals or all(n.op == '_graph_constant' for n in nodes
                       if id(n) in vals):
        return sym, 0

    new_nodes = {}
    const_nodes = {}    # (id(old node), out idx) -> materialized Node
    count = [0]

    def const_entry(node, idx):
        key = (id(node), idx)
        c = const_nodes.get(key)
        if c is None:
            name = node.name if idx == 0 else \
                '%s_out%d' % (node.name, idx)
            v = vals[id(node)][idx]
            c = Node('_graph_constant', name,
                     {'value': v.tolist(), 'dtype': str(v.dtype),
                      'shape': tuple(v.shape)}, [])
            c._extra_attr = dict(node._extra_attr)
            const_nodes[key] = c
            count[0] += 1
        return (c, 0)

    def mapped(entry):
        s, j = entry
        if not s.is_variable and id(s) in vals and \
                s.op != '_graph_constant':
            return const_entry(s, j)
        return (new_nodes[id(s)], j)

    for node in nodes:
        if node.is_variable:
            new_nodes[id(node)] = node
            continue
        if id(node) in vals and node.op != '_graph_constant':
            continue    # folded away; consumers materialize lazily
        nn = Node(node.op, node.name, node.attrs,
                  [mapped(e) for e in node.inputs])
        nn._extra_attr = node._extra_attr
        new_nodes[id(node)] = nn

    outputs = [mapped(e) for e in sym._outputs]
    if count[0] == 0:
        return sym, 0
    return Symbol(outputs), count[0]


# ---------------------------------------------------------------------------
# dead-branch elimination — identity elision + unconsumed aux heads
# ---------------------------------------------------------------------------

def prune_dead_branches(sym: Symbol, is_train=False, mode='safe'):
    """(1) ``identity`` nodes are elided unless they carry attrs or name
    a graph output; (2) a BatchNorm whose ``output_mean_var`` heads
    nothing consumes is rebuilt with ``output_mean_var=False``.
    Returns ``(symbol, rewrites)``."""
    nodes = sym.topo_nodes()
    consumers = {}
    for n in nodes:
        for s, j in n.inputs:
            consumers.setdefault((id(s), j), []).append(n)
    for s, j in sym._outputs:
        consumers.setdefault((id(s), j), []).append(None)

    emap = {}
    count = 0

    def mapped(entry):
        s, j = entry
        return (s, j) if s.is_variable else emap[(id(s), j)]

    for node in nodes:
        if node.is_variable:
            continue
        if node.op == 'identity' and not node._extra_attr and \
                None not in consumers.get((id(node), 0), []):
            emap[(id(node), 0)] = mapped(node.inputs[0])
            count += 1
            continue
        attrs = node.attrs
        if node.op == 'BatchNorm' and \
                attrs.get('output_mean_var', False) and \
                not consumers.get((id(node), 1)) and \
                not consumers.get((id(node), 2)):
            attrs = dict(attrs)
            attrs['output_mean_var'] = False
            count += 1
        nn = Node(node.op, node.name, attrs,
                  [mapped(e) for e in node.inputs])
        nn._extra_attr = node._extra_attr
        for j in range(node.num_outputs()):
            emap[(id(node), j)] = (nn, j)

    if not count:
        return sym, 0
    return Symbol([mapped(e) for e in sym._outputs]), count


# ---------------------------------------------------------------------------
# Convolution -> BatchNorm folded into the conv weights
# ---------------------------------------------------------------------------

def _conv_bn_folded_apply(attrs, inputs, is_train, rng):
    if bool(attrs.get('no_bias', True)):
        data, weight, gamma, beta, mov_mean, mov_var = inputs
        conv_bias = None
    else:
        data, weight, conv_bias, gamma, beta, mov_mean, mov_var = inputs
    eps = float(attrs.get('eps', 1e-3))
    g = torch.ones_like(gamma) if bool(attrs.get('fix_gamma', True)) \
        else gamma
    inv = g * torch.rsqrt(mov_var + eps)
    scale = inv.to(weight.dtype)
    # bn(conv + c) = conv(x, w*s) + (beta + (c - mean) * s)
    shift = mov_mean if conv_bias is None else mov_mean - conv_bias
    bias = (beta - shift * inv).to(weight.dtype)
    wshape = (weight.shape[0],) + (1,) * (weight.ndim - 1)
    conv_attrs = {k: v for k, v in attrs.items()
                  if k not in ('eps', 'momentum', 'fix_gamma',
                               'use_global_stats')}
    conv_attrs['no_bias'] = True
    outs, _ = _conv_apply(conv_attrs,
                          [data, weight * scale.reshape(wshape)],
                          is_train, rng)
    return [outs[0] + bias.reshape((1, -1) + (1,) * (data.ndim - 2))], {}


def _conv_bn_folded_complete(attrs, in_shapes):
    d = in_shapes[0]
    nf = int(attrs.get('num_filter', 0))
    if d is not None and in_shapes[1] is None and nf:
        in_shapes[1] = (nf, d[1]) + _tup_or(attrs.get('kernel'), (1, 1))
    if in_shapes[1] is not None:
        nf = in_shapes[1][0]
        for i in range(2, len(in_shapes)):
            if in_shapes[i] is None:
                in_shapes[i] = (nf,)
    return in_shapes


register('_conv_bn_folded', _conv_bn_folded_apply,
         input_names=lambda a: (
             ['data', 'weight', 'gamma', 'beta']
             if bool(a.get('no_bias', True))
             else ['data', 'weight', 'bias', 'gamma', 'beta']),
         aux_names=lambda a: ['moving_mean', 'moving_var'],
         aux_shape=lambda a, ins: [(int(a['num_filter']),)] * 2,
         num_outputs=lambda a: 1,
         complete_shapes=_conv_bn_folded_complete,
         attr_defaults={'eps': 1e-3, 'fix_gamma': True, 'no_bias': True,
                        'num_filter': 0, 'kernel': (1, 1)},
         hint='conv_bn_folded')


def fold_conv_bn(sym: Symbol, is_train=False, mode='safe'):
    """Collapse Convolution -> BatchNorm into one conv with the BN folded
    into the weights: ``bn(conv(x, w)) = conv(x, w*s) + b``, exact with
    moving statistics.  At inference every such chain folds; in training
    only a BN on moving statistics (``use_global_stats``).  Returns
    ``(symbol, rewrites)``."""
    def try_fuse(n, consumer_list, mapped_entry):
        if n.op != 'BatchNorm' or n.attrs.get('output_mean_var', False):
            return None
        if is_train and not n.attrs.get('use_global_stats', False):
            return None     # live batch statistics: fold invalid
        conv, _ = n.inputs[0]
        if (conv.is_variable or conv.op != 'Convolution'
                or int(conv.attrs.get('num_group', 1)) != 1
                or len(consumer_list(conv)) != 1):
            return None
        no_bias = bool(conv.attrs.get('no_bias', False))
        attrs = dict(conv.attrs)
        attrs['no_bias'] = no_bias
        attrs['eps'] = n.attrs.get('eps', 1e-3)
        attrs['fix_gamma'] = n.attrs.get('fix_gamma', True)
        ins = [mapped_entry(conv.inputs[0]), mapped_entry(conv.inputs[1])]
        if not no_bias:
            ins.append(mapped_entry(conv.inputs[2]))
        ins += [mapped_entry(e) for e in n.inputs[1:5]]
        fused = Node('_conv_bn_folded', n.name + '_folded', attrs, ins)
        fused._extra_attr = dict(n._extra_attr)
        return fused

    return _rewrite_counted(sym, try_fuse)


# ---------------------------------------------------------------------------
# BN->relu->conv onto the fused-prologue GEMM / implicit-GEMM conv kernels
# ---------------------------------------------------------------------------

def _bn_relu_conv_apply(attrs, inputs, is_train, rng):
    """The JAX op (``mxnet_tpu/fuse.py:128-166``): the BN stats step on
    the layout's non-channel axes folded to (scale, bias), then the 1x1
    conv as ``fused_scale_bias_dot`` over (N*H*W, C) (stride 2 slices the
    input first) or the 3x3 conv as ``fused_scale_bias_conv3x3`` on NHWC
    with HWIO weights."""
    data, gamma, beta, weight = inputs[:4]
    in_nhwc = attrs.get('in_layout', 'NCHW') == 'NHWC'
    out_nhwc = attrs.get('out_layout', 'NCHW') == 'NHWC'
    scale, bias, aux_updates = _bn_scale_bias(
        attrs, data, gamma, beta, inputs[4], inputs[5], is_train,
        axes=(0, 1, 2) if in_nhwc else (0, 2, 3))
    kernel = _tup_or(attrs.get('kernel'), (1, 1))
    stride_hw = _tup_or(attrs.get('stride'), (1, 1))
    if kernel not in ((1, 1), (3, 3)) or \
            stride_hw not in ((1, 1), (2, 2)):
        raise ValueError('_bn_relu_conv supports kernel 1x1/3x3 with '
                         'square stride 1/2, got kernel=%s stride=%s'
                         % (kernel, stride_hw))
    stride = stride_hw[0]
    x = data if in_nhwc else data.permute(0, 2, 3, 1)
    n, c = x.shape[0], x.shape[3]
    if kernel == (1, 1):
        if stride > 1:
            x = x[:, ::stride, ::stride, :]
        oh, ow = x.shape[1], x.shape[2]
        x2d = x.contiguous().reshape(-1, c)
        # (C, Nf): the transposed view of the (Nf, C) weight, which the
        # kernel reads as it lies
        w2d = weight.reshape(weight.shape[0], c).t()
        y2d = fused_scale_bias_dot(x2d, w2d.to(data.dtype), scale, bias,
                                   relu=True)
        y = y2d.reshape(n, oh, ow, -1)
    else:
        whwio = weight.permute(2, 3, 1, 0)                  # HWIO
        y = fused_scale_bias_conv3x3(x.contiguous(),
                                     whwio.to(data.dtype).contiguous(),
                                     scale, bias, stride=stride, relu=True)
    if not out_nhwc:
        y = y.permute(0, 3, 1, 2)
    return [y], aux_updates


def _bn_relu_conv_complete(attrs, in_shapes):
    d = in_shapes[0]
    if d is not None:
        c = d[3] if attrs.get('in_layout', 'NCHW') == 'NHWC' else d[1]
        for i in (1, 2):
            if in_shapes[i] is None:
                in_shapes[i] = (c,)
        if in_shapes[3] is None:
            k = _tup_or(attrs.get('kernel'), (1, 1))
            in_shapes[3] = (int(attrs['num_filter']), c) + k
    return in_shapes


def _bn_relu_conv_aux_shape(attrs, in_shapes):
    d = in_shapes[0]
    c = d[3] if attrs.get('in_layout', 'NCHW') == 'NHWC' else d[1]
    return [(c,), (c,)]


register('_bn_relu_conv', _bn_relu_conv_apply,
         input_names=lambda a: ['data', 'gamma', 'beta', 'weight'],
         aux_names=lambda a: ['moving_mean', 'moving_var'],
         aux_shape=_bn_relu_conv_aux_shape,
         num_outputs=lambda a: 1,
         complete_shapes=_bn_relu_conv_complete,
         attr_defaults={'eps': 1e-3, 'momentum': 0.9, 'fix_gamma': True,
                        'use_global_stats': False, 'num_filter': 0,
                        'kernel': (1, 1), 'stride': (1, 1)},
         hint='bn_relu_conv')


def _is_fusable_conv(node: Node) -> bool:
    if node.op != 'Convolution' or not node.attrs.get('no_bias', False):
        return False
    a = node.attrs
    if a.get('pad_hi') or int(a.get('num_group', 1)) != 1:
        return False
    if _tup_or(a.get('dilate'), (1, 1)) != (1, 1):
        return False
    kernel = tuple(a.get('kernel', ()))
    stride = _tup_or(a.get('stride'), (1, 1))
    pad = _tup_or(a.get('pad'), (0, 0))
    if stride not in ((1, 1), (2, 2)):
        return False
    if kernel == (1, 1):
        return pad == (0, 0)
    if kernel == (3, 3):
        return pad == (1, 1)
    return False


def _try_fuse_bn_relu_conv(n, consumer_list, mapped_entry):
    """The JAX matcher (``mxnet_tpu/fuse.py:389-424``): a conv fed by
    relu(BN(x)) where every consumer of the relu is a fusable conv and
    the BN feeds only that relu."""
    if not _is_fusable_conv(n):
        return None
    act, _ = n.inputs[0]
    if (act.is_variable or act.op != 'Activation'
            or act.attrs.get('act_type') != 'relu'
            or not all(c is not None and _is_fusable_conv(c)
                       for c in consumer_list(act))):
        return None
    bn, _ = act.inputs[0]
    if (bn.is_variable or bn.op != 'BatchNorm'
            or len(consumer_list(bn)) != 1
            or bn.attrs.get('output_mean_var', False)):
        return None
    attrs = {'eps': bn.attrs.get('eps', 1e-3),
             'momentum': bn.attrs.get('momentum', 0.9),
             'fix_gamma': bn.attrs.get('fix_gamma', True),
             'use_global_stats': bn.attrs.get('use_global_stats', False),
             'num_filter': n.attrs['num_filter'],
             'kernel': tuple(n.attrs.get('kernel', (1, 1))),
             'stride': _tup_or(n.attrs.get('stride'), (1, 1))}
    # bn inputs: data gamma beta + aux mean/var; conv inputs: act weight
    ins = [mapped_entry(bn.inputs[0]), mapped_entry(bn.inputs[1]),
           mapped_entry(bn.inputs[2]), mapped_entry(n.inputs[1]),
           mapped_entry(bn.inputs[3]), mapped_entry(bn.inputs[4])]
    fused = Node('_bn_relu_conv', n.name + '_fused', attrs, ins)
    fused._extra_attr = dict(n._extra_attr)
    return fused


def _pass_bn_relu_conv(sym, is_train, mode='safe'):
    """Collapse every BN->relu->conv chain whose relu feeds only fusable
    convs into per-conv ``_bn_relu_conv`` nodes.  Returns ``(symbol,
    rewrites)``."""
    return _rewrite_counted(sym, _try_fuse_bn_relu_conv)


# elementwise ops that pass NHWC data through untouched (same-shape
# two-operand arithmetic; anything axis-sensitive is a region boundary)
_LAYOUT_FLEX = {'_plus', 'elemwise_add', '_grad_add', '_minus', '_mul'}
# single-operand elementwise ops a channels-last region grows across
_LAYOUT_FLEX_UNARY = {'Activation', 'clip'}


def _layout_transpose_name(src_name, out_idx, want):
    """Name of a layout-conversion transpose node; the output index
    disambiguates two outputs of one multi-output node."""
    suffix = '' if out_idx == 0 else '_out%d' % out_idx
    return '%s%s_to_%s' % (src_name, suffix, want.lower())


def _pass_nhwc_regions(sym, is_train, mode='safe'):
    """Keep fused chains channels-last end to end (the JAX region pass,
    ``mxnet_tpu/fuse.py:291-386``): every ``_bn_relu_conv`` produces
    NHWC, elementwise ops between them (residual adds, relu/clip) run on
    NHWC data unchanged, and an explicit ``transpose`` node appears only
    where an NHWC tensor meets a layout-sensitive consumer or a graph
    output.  Returns ``(symbol, region nodes)``."""
    nodes = sym.topo_nodes()
    if not any(n.op == '_bn_relu_conv' for n in nodes
               if not n.is_variable):
        return sym, 0
    grown = 0
    mapping = {}     # id(old node) -> new node
    layout = {}      # (id(new node), idx) -> 'NCHW' | 'NHWC'
    to_nchw_cache = {}
    to_nhwc_cache = {}

    def mapped(entry):
        return (mapping[id(entry[0])], entry[1])

    def layout_of(entry):
        new_entry = mapped(entry)
        return layout.get((id(new_entry[0]), new_entry[1]), 'NCHW')

    def as_layout(entry, want):
        """Entry in the requested layout, inserting (and sharing) a
        transpose node when needed."""
        new_entry = mapped(entry)
        if layout_of(entry) == want:
            return new_entry
        cache = to_nhwc_cache if want == 'NHWC' else to_nchw_cache
        key = (id(new_entry[0]), new_entry[1])
        t = cache.get(key)
        if t is None:
            axes = (0, 2, 3, 1) if want == 'NHWC' else (0, 3, 1, 2)
            t = Node('transpose',
                     _layout_transpose_name(entry[0].name, new_entry[1],
                                            want),
                     {'axes': axes}, [new_entry])
            cache[key] = t
        return (t, 0)

    for n in nodes:
        if n.is_variable:
            mapping[id(n)] = n
            continue
        if n.op == '_bn_relu_conv':
            attrs = dict(n.attrs)
            attrs['in_layout'] = layout_of(n.inputs[0])
            attrs['out_layout'] = 'NHWC'
            new = Node(n.op, n.name, attrs,
                       [mapped(e) for e in n.inputs])
            layout[(id(new), 0)] = 'NHWC'
            grown += 1
        elif n.op in _LAYOUT_FLEX and len(n.inputs) == 2 and any(
                layout_of(e) == 'NHWC' for e in n.inputs):
            # grow the region: both operands to NHWC, output NHWC
            new = Node(n.op, n.name, n.attrs,
                       [as_layout(e, 'NHWC') for e in n.inputs])
            layout[(id(new), 0)] = 'NHWC'
            grown += 1
        elif n.op in _LAYOUT_FLEX_UNARY and len(n.inputs) == 1 and \
                n.num_outputs() == 1 and layout_of(n.inputs[0]) == 'NHWC':
            # single-operand elementwise: the data passes through in
            # whatever layout it arrived
            new = Node(n.op, n.name, n.attrs, [mapped(n.inputs[0])])
            layout[(id(new), 0)] = 'NHWC'
            grown += 1
        else:
            new = Node(n.op, n.name, n.attrs,
                       [as_layout(e, 'NCHW') for e in n.inputs])
        new._extra_attr = n._extra_attr
        mapping[id(n)] = new

    return Symbol([as_layout(e, 'NCHW') for e in sym._outputs]), grown


# ---------------------------------------------------------------------------
# BN->relu onto the fused_bn_relu kernel
# ---------------------------------------------------------------------------

def _bn_relu_apply(attrs, inputs, is_train, rng):
    data, gamma, beta, mov_mean, mov_var = inputs
    axes = (0,) + tuple(range(2, data.ndim))
    scale, bias, aux_updates = _bn_scale_bias(
        attrs, data, gamma, beta, mov_mean, mov_var, is_train, axes=axes)
    return [fused_bn_relu(data.contiguous(), scale, bias)], aux_updates


def _bn_relu_complete(attrs, in_shapes):
    d = in_shapes[0]
    if d is not None:
        for i in (1, 2):
            if in_shapes[i] is None:
                in_shapes[i] = (d[1],)
    return in_shapes


register('_bn_relu', _bn_relu_apply,
         input_names=lambda a: ['data', 'gamma', 'beta'],
         aux_names=lambda a: ['moving_mean', 'moving_var'],
         num_outputs=lambda a: 1,
         complete_shapes=_bn_relu_complete,
         attr_defaults={'eps': 1e-3, 'momentum': 0.9, 'fix_gamma': True,
                        'use_global_stats': False},
         hint='bn_relu')


def fuse_bn_relu(sym: Symbol, is_train=False, mode='safe'):
    """Collapse BN->relu chains (the BN feeding only the relu) into
    ``_bn_relu`` nodes lowered onto ``fused_bn_relu``.  Runs after
    ``bn_relu_conv``.  Returns ``(symbol, rewrites)``."""
    def try_fuse(n, consumer_list, mapped_entry):
        if n.op != 'Activation' or n.attrs.get('act_type') != 'relu':
            return None
        bn, bidx = n.inputs[0]
        if (bn.is_variable or bn.op != 'BatchNorm' or bidx != 0
                or len(consumer_list(bn)) != 1
                or bn.attrs.get('output_mean_var', False)):
            return None
        attrs = {'eps': bn.attrs.get('eps', 1e-3),
                 'momentum': bn.attrs.get('momentum', 0.9),
                 'fix_gamma': bn.attrs.get('fix_gamma', True),
                 'use_global_stats': bn.attrs.get('use_global_stats',
                                                  False)}
        fused = Node('_bn_relu', n.name, attrs,
                     [mapped_entry(e) for e in bn.inputs])
        fused._extra_attr = dict(n._extra_attr)
        return fused

    return _rewrite_counted(sym, try_fuse)


# ---------------------------------------------------------------------------
# elementwise-epilogue fusion — bias-add/relu/clip chains into the producer
# ---------------------------------------------------------------------------

_EPILOGUE_BASE_OPS = ('Convolution', 'FullyConnected', 'dot')
# two-operand steps admitted when the OTHER operand is a parameter
# variable (the bias/scale patterns); aliases listed because node.op
# records the construction-time name
_EPILOGUE_BINARY = ('_plus', 'elemwise_add', 'broadcast_add',
                    'broadcast_plus', '_mul', 'elemwise_mul',
                    'broadcast_mul')
_EPILOGUE_ADD = ('_plus', 'elemwise_add', 'broadcast_add',
                 'broadcast_plus')


def _admissible_epilogue_step(nxt, cur):
    """Step descriptor when ``nxt`` (sole consumer of ``cur``) can fold
    into the producer's epilogue, else None."""
    if nxt.op in ('Activation', 'clip'):
        if nxt.op == 'Activation' and nxt.attrs.get('act_type') != 'relu':
            return None
        if len(nxt.inputs) != 1 or nxt.inputs[0][0] is not cur:
            return None
        return {'node': nxt, 'y_index': 0, 'extra': None}
    if nxt.op in _EPILOGUE_BINARY:
        if len(nxt.inputs) != 2:
            return None
        sides = [i for i, (s, j) in enumerate(nxt.inputs)
                 if s is cur and j == 0]
        if len(sides) != 1:
            return None
        other = nxt.inputs[1 - sides[0]]
        if not other[0].is_variable:
            return None
        return {'node': nxt, 'y_index': sides[0], 'extra': other}
    return None


def _try_lower_epilogue(attrs, base_attrs, inputs, nbase):
    """The JAX package's ``_try_lower_epilogue``
    (``mxnet_tpu/fuse.py:902-955``): a FullyConnected chain stamped
    ``lower_kernel`` (aggressive) and matching ``[bias-add] [relu]
    [clip(lo, hi)]`` in that order, each added bias 1-D of the FC's
    width, runs as ONE ``fused_dot_epilogue``; anything else (a second
    clip, a multiply) returns None for the exact replay.  The weight goes
    in as it lies, (N, K): ``weight.t()`` is a view the kernel reads
    without a copy."""
    if attrs['base_op'] != 'FullyConnected' or \
            not attrs.get('lower_kernel', False):
        return None
    data, weight = inputs[0], inputs[1]
    bias = None if bool(base_attrs.get('no_bias', False)) else inputs[2]
    relu = False
    clip = None
    stage = 0           # 0: bias-add, 1: relu, 2: clip — forward-only
    ei = nbase
    for st in attrs['steps']:
        if st['op'] in _EPILOGUE_BINARY:
            if stage > 0 or st['op'] not in _EPILOGUE_ADD:
                return None
            extra = inputs[ei]
            ei += 1
            if extra.ndim != 1 or extra.shape[0] != weight.shape[0]:
                return None
            bias = extra if bias is None else bias + extra
            stage = 1
        elif st['op'] == 'Activation':
            if stage > 1:
                return None
            relu = True
            stage = 2
        elif st['op'] == 'clip':
            if stage > 2:
                return None     # second clip: fall back to the replay
            sattrs = st['attrs']
            if sattrs.get('a_min') is None or sattrs.get('a_max') is None:
                return None
            clip = (float(sattrs['a_min']), float(sattrs['a_max']))
            stage = 3
        else:
            return None
    x2 = data.reshape(data.shape[0], -1).contiguous()
    return fused_dot_epilogue(x2, weight.t(), bias, relu=relu, clip=clip)


def _fused_epilogue_apply(attrs, inputs, is_train, rng):
    """The kernel lowering where it applies, else exact replay: the SAME
    ops in the SAME order the unfused graph ran them."""
    base = get_op(attrs['base_op'])
    nbase = int(attrs['num_base_inputs'])
    base_attrs = base.canon_attrs(attrs['base_attrs'])
    lowered = _try_lower_epilogue(attrs, base_attrs, inputs, nbase)
    if lowered is not None:
        return [lowered], {}
    outs, aux = base.apply(base_attrs, list(inputs[:nbase]), is_train, rng)
    y = outs[0]
    ei = nbase
    for st in attrs['steps']:
        op = get_op(st['op'])
        if st['has_extra']:
            other = inputs[ei]
            ei += 1
            ins = [y, other] if st['y_index'] == 0 else [other, y]
        else:
            ins = [y]
        y = op.apply(op.canon_attrs(st['attrs']), ins, is_train, rng)[0][0]
    return [y], aux


register('_fused_epilogue', _fused_epilogue_apply,
         input_names=lambda a: (
             list(get_op(a['base_op']).input_names(a['base_attrs']))
             + ['ep%d' % i for i in range(int(a.get('num_extra', 0)))]),
         num_outputs=lambda a: 1,
         attr_defaults={'num_extra': 0},
         hint='fused_epilogue')


def fuse_epilogues(sym: Symbol, is_train=False, mode='safe'):
    """Collapse elementwise chains following Convolution /
    FullyConnected / dot — parameter bias-adds, relu, clip — into ONE
    ``_fused_epilogue`` node replaying the chain.  Only single-consumer
    intermediates fold.  Under ``aggressive`` the node is stamped
    ``lower_kernel``: a FullyConnected chain then runs as
    ``fused_dot_epilogue`` (:func:`_try_lower_epilogue`).  Returns
    ``(symbol, chains fused)``."""
    nodes = sym.topo_nodes()
    consumers = {}
    for n in nodes:
        for s, j in n.inputs:
            consumers.setdefault((id(s), j), []).append(n)
    for s, j in sym._outputs:
        consumers.setdefault((id(s), j), []).append(None)

    chains = {}         # id(producer) -> (steps, tail node)
    in_chain = set()
    for n in nodes:
        if n.is_variable or n.op not in _EPILOGUE_BASE_OPS:
            continue
        steps = []
        cur = n
        while True:
            cons = consumers.get((id(cur), 0), [])
            if len(cons) != 1 or cons[0] is None:
                break
            st = _admissible_epilogue_step(cons[0], cur)
            if st is None:
                break
            steps.append(st)
            cur = cons[0]
        if not steps:
            continue
        chains[id(n)] = (steps, cur)
        in_chain.update(id(st['node']) for st in steps)

    if not chains:
        return sym, 0

    emap = {}

    def mapped(entry):
        s, j = entry
        return (s, j) if s.is_variable else emap[(id(s), j)]

    for n in nodes:
        if n.is_variable or id(n) in in_chain:
            continue
        chain = chains.get(id(n))
        if chain is None:
            nn = Node(n.op, n.name, n.attrs, [mapped(e) for e in n.inputs])
            nn._extra_attr = n._extra_attr
            for j in range(n.num_outputs()):
                emap[(id(n), j)] = (nn, j)
            continue
        steps, tail = chain
        ins = [mapped(e) for e in n.inputs]
        descs = []
        for st in steps:
            descs.append({'op': st['node'].op,
                          'attrs': dict(st['node'].attrs),
                          'y_index': st['y_index'],
                          'has_extra': st['extra'] is not None})
            if st['extra'] is not None:
                ins.append(mapped(st['extra']))
        attrs = {'base_op': n.op, 'base_attrs': dict(n.attrs),
                 'num_base_inputs': len(n.inputs), 'steps': descs,
                 'num_extra': len(ins) - len(n.inputs),
                 'lower_kernel': mode == 'aggressive'}
        fused = Node('_fused_epilogue', tail.name, attrs, ins)
        fused._extra_attr = dict(tail._extra_attr)
        emap[(id(n), 0)] = (fused, 0)
        emap[(id(tail), 0)] = (fused, 0)

    return Symbol([mapped(e) for e in sym._outputs]), len(chains)


# ---------------------------------------------------------------------------
# the pass manager
# ---------------------------------------------------------------------------

class FusePass(object):
    """One named pass ``fn(sym, is_train, mode) -> (sym, rewrites)``;
    'safe' passes run under ``MXTPU_FUSE=safe`` and above, 'aggressive'
    ones only under ``aggressive``."""

    __slots__ = ('name', 'level', 'fn')

    def __init__(self, name, level, fn):
        if level not in ('safe', 'aggressive'):
            raise ValueError('pass level must be safe|aggressive, got %r'
                             % (level,))
        self.name = name
        self.level = level
        self.fn = fn

    def __repr__(self):
        return 'FusePass(%s, %s)' % (self.name, self.level)


def default_passes():
    """The pipeline, in the JAX package's execution order."""
    return [
        FusePass('constant_fold', 'safe', fold_constants),
        FusePass('dead_branch', 'safe', prune_dead_branches),
        FusePass('conv_bn_fold', 'aggressive', fold_conv_bn),
        FusePass('bn_relu_conv', 'aggressive', _pass_bn_relu_conv),
        FusePass('bn_relu', 'aggressive', fuse_bn_relu),
        FusePass('epilogue', 'safe', fuse_epilogues),
        FusePass('nhwc_regions', 'aggressive', _pass_nhwc_regions),
    ]


class PassManager(object):
    """Sequenced pass pipeline; ``run`` applies the enabled passes in
    order and records per-pass ``{rewrites, nodes_removed}`` in
    ``last_stats``."""

    def __init__(self, passes=None):
        self.passes = list(passes) if passes is not None \
            else default_passes()
        self.last_stats = None

    def run(self, sym, is_train, mode='safe', skip=()):
        stats = {}
        total = 0
        for p in self.passes:
            if p.name in skip:
                continue
            if p.level == 'aggressive' and mode != 'aggressive':
                continue
            before = len(sym.topo_nodes())
            out, n = p.fn(sym, is_train, mode)
            stats[p.name] = {'rewrites': int(n),
                             'nodes_removed': max(
                                 0, before - len(out.topo_nodes()))}
            total += int(n)
            sym = out
        self.last_stats = {'mode': mode, 'is_train': bool(is_train),
                           'total_rewrites': total, 'passes': stats}
        return sym


_MANAGER = None


def default_manager() -> PassManager:
    global _MANAGER
    if _MANAGER is None:
        _MANAGER = PassManager()
    return _MANAGER


def last_run_stats():
    """Per-pass stats of the most recent pipeline run (None before the
    first)."""
    return None if _MANAGER is None else _MANAGER.last_stats


_MODES = ('off', 'safe', 'aggressive')


def fuse_mode():
    """``MXTPU_FUSE``, or the legacy ``MXTPU_FUSE_BN_CONV`` when unset;
    an unrecognized value raises."""
    from . import config
    raw = str(config.get('MXTPU_FUSE') or '').strip().lower()
    if raw in _MODES:
        return raw
    if raw:
        raise ValueError('MXTPU_FUSE must be off|safe|aggressive, '
                         'got %r' % raw)
    return 'aggressive' if config.get('MXTPU_FUSE_BN_CONV') else 'off'


def apply_fuse_passes(symbol: Symbol, is_train, mode=None) -> Symbol:
    """Run the pass pipeline over a symbol about to execute.  ``mode``
    None reads the knobs; 'off' returns the input symbol untouched."""
    if mode is None:
        mode = fuse_mode()
    if mode == 'off':
        return symbol
    from . import config
    skip = tuple(s.strip() for s in
                 str(config.get('MXTPU_FUSE_SKIP') or '').split(',')
                 if s.strip())
    manager = default_manager()
    known = {p.name for p in manager.passes}
    unknown = sorted(set(skip) - known)
    if unknown:
        raise ValueError('MXTPU_FUSE_SKIP names unknown passes %s '
                         '(have: %s)' % (unknown, sorted(known)))
    return manager.run(symbol, is_train, mode, skip=skip)
