"""VGG-11/13/16/19, with optional BatchNorm (reference
example/image-classification/symbols/vgg.py) — the port's copy
of ``mxnet_tpu/models/vgg.py``: the same graph and node names, built
through ``mxnet_tpu_torch.symbol``."""
from .. import symbol as sym

_CONFIGS = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _CONFIGS:
        raise ValueError('invalid num_layers %d; choices %s'
                         % (num_layers, sorted(_CONFIGS)))
    layers, filters = _CONFIGS[num_layers]
    data = sym.Variable('data')
    net = data
    for i, num in enumerate(layers):
        for j in range(num):
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters[i],
                                  name='conv%d_%d' % (i + 1, j + 1))
            if batch_norm:
                net = sym.BatchNorm(net, name='bn%d_%d' % (i + 1, j + 1))
            net = sym.Activation(net, act_type='relu',
                                 name='relu%d_%d' % (i + 1, j + 1))
        net = sym.Pooling(net, pool_type='max', kernel=(2, 2),
                          stride=(2, 2), name='pool%d' % (i + 1))
    net = sym.Flatten(net, name='flatten')
    net = sym.FullyConnected(net, num_hidden=4096, name='fc6')
    net = sym.Activation(net, act_type='relu', name='relu6')
    net = sym.Dropout(net, p=0.5, name='drop6')
    net = sym.FullyConnected(net, num_hidden=4096, name='fc7')
    net = sym.Activation(net, act_type='relu', name='relu7')
    net = sym.Dropout(net, p=0.5, name='drop7')
    net = sym.FullyConnected(net, num_hidden=num_classes, name='fc8')
    return sym.SoftmaxOutput(net, name='softmax')
