"""ResNet v2 (pre-activation) family — the port's copy of
``mxnet_tpu/models/resnet.py`` (reference
example/image-classification/symbols/resnet.py), building the same
graph with the same node names through ``mxnet_tpu_torch.symbol``.
"""
from .. import symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn1')
        act1 = sym.Activation(bn1, act_type='relu', name=name + '_relu1')
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + '_conv1')
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn2')
        act2 = sym.Activation(bn2, act_type='relu', name=name + '_relu2')
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + '_conv2')
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn3')
        act3 = sym.Activation(bn3, act_type='relu', name=name + '_relu3')
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + '_conv3')
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + '_sc')
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + '_bn1')
    act1 = sym.Activation(bn1, act_type='relu', name=name + '_relu1')
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + '_conv1')
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + '_bn2')
    act2 = sym.Activation(bn2, act_type='relu', name=name + '_relu2')
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + '_conv2')
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + '_sc')
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, stem='classic'):
    num_unit = len(units)
    assert num_unit == num_stages
    data = sym.Variable('data')
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name='bn_data')
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name='conv0')
    elif stem == 'space_to_depth':
        # MLPerf-style stem rewrite: the 7x7/stride-2 conv over 3 input
        # channels keeps the MXU almost idle (3 of 128 lanes) and its
        # data-gradient — needed for bn_data's beta — is the single
        # slowest op in the ResNet-50 training step.  Space-to-depth
        # moves each 2x2 spatial patch into channels ([N,3,H,W] ->
        # [N,12,H/2,W/2]) so the SAME function becomes a dense
        # 4x4/stride-1 conv over 12 channels.  Mathematically exact:
        # stem_weight_to_s2d maps classic conv0 weights onto s2d conv0
        # weights reproducing identical outputs (tests/test_models.py).
        h2, w2 = height // 2, width // 2
        body = sym.Reshape(data, shape=(0, nchannel, h2, 2, w2, 2))
        body = sym.transpose(body, axes=(0, 1, 3, 5, 2, 4))
        body = sym.Reshape(body, shape=(0, nchannel * 4, h2, w2))
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(4, 4), stride=(1, 1), pad=(2, 2),
                               pad_hi=(1, 1), no_bias=True, name='conv0')
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name='bn0')
        body = sym.Activation(body, act_type='relu', name='relu0')
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type='max')
    else:  # imagenet
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name='conv0')
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name='bn0')
        body = sym.Activation(body, act_type='relu', name='relu0')
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type='max')

    for i in range(num_stages):
        body = residual_unit(body, filter_list[i + 1],
                             (1 if i == 0 else 2, 1 if i == 0 else 2),
                             False, name='stage%d_unit%d' % (i + 1, 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name='stage%d_unit%d' % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name='bn1')
    relu1 = sym.Activation(bn1, act_type='relu', name='relu1')
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type='avg', name='pool1')
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(fc1, name='softmax')


def stem_weight_to_s2d(weight):
    """Map classic conv0 weights (O, C, 7, 7) onto space-to-depth conv0
    weights (O, C*4, 4, 4) such that both stems compute the SAME function:
    ``W'[o, c*4 + a*2 + b, u, v] = W[o, c, 2u+a-1, 2v+b-1]`` (zero where
    the index underflows).  Takes numpy arrays or CPU tensors; returns
    numpy."""
    import numpy as _np
    w = _np.asarray(weight)
    o, c, kh, kw = w.shape
    assert (kh, kw) == (7, 7), 'classic stem kernel must be 7x7'
    wp = _np.zeros((o, c, 8, 8), w.dtype)
    wp[:, :, 1:, 1:] = w  # index -1 becomes row/col 0 of the padded copy
    out = _np.empty((o, c * 4, 4, 4), w.dtype)
    for a in range(2):
        for b in range(2):
            # W'[u] = Wp[2u+a] (padded so kh=-1 -> 0)
            out[:, a * 2 + b::4, :, :] = wp[:, :, a::2, b::2]
    return out


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               stem='classic', **kwargs):
    """Depth → stage plan, same arithmetic as the reference resnet.py."""
    image_shape = tuple(image_shape)
    (nchannel, height, width) = image_shape
    if height <= 32:            # cifar-sized inputs (reference resnet.py:92)
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError('no experiments done on num_layers %d'
                             % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                     200: [3, 24, 36, 3], 269: [3, 30, 48, 8]}
        if num_layers not in units_map:
            raise ValueError('no experiments done on num_layers %d'
                             % num_layers)
        units = units_map[num_layers]

    return resnet(units=units, num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=image_shape, bottle_neck=bottle_neck,
                  stem=stem)
