"""ResNeXt (reference example/image-classification/symbols/resnext.py;
Xie et al., arXiv:1611.05431): ResNet bottlenecks with grouped 3x3
convolutions — the port's copy
of ``mxnet_tpu/models/resnext.py``: the same graph and node names, built
through ``mxnet_tpu_torch.symbol``."""
from .. import symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, num_group=32, bn_mom=0.9):
    if bottle_neck:
        conv1 = sym.Convolution(data, num_filter=num_filter // 2,
                                kernel=(1, 1), no_bias=True,
                                name=name + '_conv1')
        bn1 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn1')
        act1 = sym.Activation(bn1, act_type='relu',
                              name=name + '_relu1')
        conv2 = sym.Convolution(act1, num_filter=num_filter // 2,
                                num_group=num_group, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + '_conv2')
        bn2 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn2')
        act2 = sym.Activation(bn2, act_type='relu',
                              name=name + '_relu2')
        conv3 = sym.Convolution(act2, num_filter=num_filter,
                                kernel=(1, 1), no_bias=True,
                                name=name + '_conv3')
        body = sym.BatchNorm(conv3, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name=name + '_bn3')
    else:
        conv1 = sym.Convolution(data, num_filter=num_filter,
                                kernel=(3, 3), stride=stride,
                                pad=(1, 1), no_bias=True,
                                name=name + '_conv1')
        bn1 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + '_bn1')
        act1 = sym.Activation(bn1, act_type='relu',
                              name=name + '_relu1')
        conv2 = sym.Convolution(act1, num_filter=num_filter,
                                kernel=(3, 3), pad=(1, 1), no_bias=True,
                                name=name + '_conv2')
        body = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name=name + '_bn2')
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True,
                             name=name + '_sc')
        shortcut = sym.BatchNorm(sc, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name=name + '_sc_bn')
    return sym.Activation(body + shortcut, act_type='relu',
                          name=name + '_relu')


def resnext(units, num_stages, filter_list, num_classes, num_group,
            image_shape=(3, 224, 224), bottle_neck=True, bn_mom=0.9):
    data = sym.Variable('data')
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5,
                         momentum=bn_mom, name='bn_data')
    if image_shape[1] <= 32:                      # cifar-style stem
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), pad=(1, 1), no_bias=True,
                               name='conv0')
    else:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name='conv0')
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name='bn0')
        body = sym.Activation(body, act_type='relu', name='relu0')
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type='max')
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             'stage%d_unit%d' % (i + 1, 1),
                             bottle_neck=bottle_neck,
                             num_group=num_group, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 'stage%d_unit%d' % (i + 1, j + 2),
                                 bottle_neck=bottle_neck,
                                 num_group=num_group, bn_mom=bn_mom)
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type='avg', name='pool1')
    flat = sym.Flatten(pool)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(fc1, name='softmax')


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape=(3, 224, 224), **kwargs):
    """resnext-50/101/152 (imagenet) and the cifar depths (reference
    resnext.py get_symbol unit tables)."""
    h = image_shape[1]
    if h <= 32:
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per = (num_layers - 2) // 9
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per = (num_layers - 2) // 6
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError('invalid cifar resnext depth %d'
                             % num_layers)
        units = [per] * 3
        num_stages = 3
    else:
        num_stages = 4
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        units = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}.get(num_layers)
        if units is None:
            raise ValueError('invalid imagenet resnext depth %d'
                             % num_layers)
    return resnext(units, num_stages, filter_list, num_classes,
                   num_group, image_shape=image_shape,
                   bottle_neck=bottle_neck)
