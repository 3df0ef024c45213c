"""SSD detector with the reduced-VGG16 backbone — the port's copy of
``mxnet_tpu/models/ssd.py``, building the same graph with the same node
names through ``mxnet_tpu_torch.symbol``.

Reference: ``example/ssd/symbol/symbol_vgg16_reduced.py`` (body + heads) and
``example/ssd/symbol/common.py`` (``multibox_layer`` head aggregation).
Built programmatically instead of the reference's copy-pasted layer blocks,
but producing the same topology: VGG16 with pool5 3x3/s1, dilated conv6,
1x1 conv7, four extra conv stages, global pool, and per-scale
loc/cls/anchor heads feeding MultiBoxTarget (train) or MultiBoxDetection
(deploy).
"""
from .. import symbol as sym

# (sizes, ratios) per source layer — symbol_vgg16_reduced.py:111-114
_SIZES = [[.1], [.2, .276], [.38, .461], [.56, .644], [.74, .825],
          [.92, 1.01]]
_RATIOS = [[1, 2, .5]] + [[1, 2, .5, 3, 1. / 3]] * 5


def _conv_relu(net, name, num_filter, kernel, pad, stride=(1, 1),
               dilate=None):
    net = sym.Convolution(net, kernel=kernel, pad=pad, stride=stride,
                          num_filter=num_filter,
                          **({'dilate': dilate} if dilate else {}),
                          name='conv%s' % name)
    return sym.Activation(net, act_type='relu', name='relu%s' % name)


def _vgg16_reduced(data):
    """Returns the six multi-scale source layers."""
    net = data
    # groups 1-5 (pool3 uses the 'full' ceil convention; pool5 is 3x3/s1)
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    sources = []
    for gi, (n, f) in enumerate(cfg, 1):
        for li in range(1, n + 1):
            net = _conv_relu(net, '%d_%d' % (gi, li), f, (3, 3), (1, 1))
        if gi == 4:
            sources.append(net)                      # relu4_3
        if gi == 5:
            net = sym.Pooling(net, pool_type='max', kernel=(3, 3),
                              stride=(1, 1), pad=(1, 1), name='pool5')
        else:
            net = sym.Pooling(
                net, pool_type='max', kernel=(2, 2), stride=(2, 2),
                pooling_convention='full' if gi == 3 else 'valid',
                name='pool%d' % gi)
    net = _conv_relu(net, '6', 1024, (3, 3), (6, 6), dilate=(6, 6))
    net = _conv_relu(net, '7', 1024, (1, 1), (0, 0))
    sources.append(net)                              # relu7
    net = _conv_relu(net, '8_1', 256, (1, 1), (0, 0))
    net = _conv_relu(net, '8_2', 512, (3, 3), (1, 1), stride=(2, 2))
    sources.append(net)                              # relu8_2
    net = _conv_relu(net, '9_1', 128, (1, 1), (0, 0))
    net = _conv_relu(net, '9_2', 256, (3, 3), (1, 1), stride=(2, 2))
    sources.append(net)                              # relu9_2
    net = _conv_relu(net, '10_1', 128, (1, 1), (0, 0))
    net = _conv_relu(net, '10_2', 256, (3, 3), (1, 1), stride=(2, 2))
    sources.append(net)                              # relu10_2
    pool10 = sym.Pooling(net, pool_type='avg', global_pool=True,
                         kernel=(1, 1), name='pool10')
    sources.append(pool10)
    return sources


def _multibox_layer(sources, num_classes, clip=True):
    """Per-scale loc/cls/anchor heads (common.py:41-180).  num_classes
    INCLUDES background here (the reference adds background internally)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    for k, layer in enumerate(sources):
        if k == 0:
            # relu4_3 feature scaling: L2-normalize channels, learnable
            # scale initialised around 20 (common.py:113-126)
            from ..initializer import Constant
            scale = sym.Variable('relu4_3_scale',
                                 shape=(1, 512, 1, 1),
                                 init=Constant(20.0))
            layer = sym.broadcast_mul(
                scale, sym.L2Normalization(layer, mode='channel'),
                name='relu4_3_norm')
        num_anchors = len(_SIZES[k]) - 1 + len(_RATIOS[k])
        loc = sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name='scale%d_loc_pred_conv' % k)
        loc = sym.Flatten(sym.transpose(loc, axes=(0, 2, 3, 1)))
        loc_layers.append(loc)
        cls = sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_classes,
                              name='scale%d_cls_pred_conv' % k)
        cls = sym.Flatten(sym.transpose(cls, axes=(0, 2, 3, 1)))
        cls_layers.append(cls)
        anchors = sym.MultiBoxPrior(layer, sizes=tuple(_SIZES[k]),
                                    ratios=tuple(_RATIOS[k]), clip=clip,
                                    name='scale%d_anchors' % k)
        anchor_layers.append(sym.Flatten(anchors))

    loc_preds = sym.Concat(*loc_layers, num_args=len(loc_layers), dim=1,
                           name='multibox_loc_pred')
    cls_preds = sym.Concat(*cls_layers, num_args=len(cls_layers), dim=1)
    cls_preds = sym.Reshape(cls_preds, shape=(0, -1, num_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name='multibox_cls_pred')
    anchors = sym.Concat(*anchor_layers, num_args=len(anchor_layers), dim=1)
    anchors = sym.Reshape(anchors, shape=(0, -1, 4), name='multibox_anchors')
    return loc_preds, cls_preds, anchors


def get_symbol_train(num_classes=20, **kwargs):
    """Training graph: cls softmax + smooth-L1 loc loss
    (symbol_vgg16_reduced.py:117-144).  ``num_classes`` excludes
    background."""
    data = sym.Variable('data')
    label = sym.Variable('label')
    sources = _vgg16_reduced(data)
    loc_preds, cls_preds, anchors = _multibox_layer(
        sources, num_classes + 1, clip=True)
    tmp = sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=.5, ignore_label=-1,
        negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=.5, variances=(0.1, 0.1, 0.2, 0.2),
        name='multibox_target')
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target, ignore_label=-1,
                                 use_ignore=True, grad_scale=3.,
                                 multi_output=True, normalization='valid',
                                 name='cls_prob')
    loc_loss_ = sym.smooth_l1(loc_target_mask * (loc_preds - loc_target),
                              scalar=1.0, name='loc_loss_')
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1., normalization='valid',
                            name='loc_loss')
    cls_label = sym.MakeLoss(cls_target, grad_scale=0, name='cls_label')
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=True,
               **kwargs):
    """Deploy graph: softmax + MultiBoxDetection NMS
    (symbol_vgg16_reduced.py:147-171)."""
    data = sym.Variable('data')
    sources = _vgg16_reduced(data)
    loc_preds, cls_preds, anchors = _multibox_layer(
        sources, num_classes + 1, clip=True)
    cls_prob = sym.SoftmaxActivation(cls_preds, mode='channel',
                                     name='cls_prob')
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                 name='detection', nms_threshold=nms_thresh,
                                 force_suppress=force_suppress,
                                 variances=(0.1, 0.1, 0.2, 0.2))
