"""GoogLeNet / Inception-v1 (Szegedy et al., arXiv:1409.4842; reference
example/image-classification/symbols/googlenet.py) — the port's copy
of ``mxnet_tpu/models/googlenet.py``: the same graph and node names, built
through ``mxnet_tpu_torch.symbol``."""
from .. import symbol as sym


def _conv_relu(x, width, kernel, name, stride=(1, 1), pad=(0, 0),
               suffix=''):
    x = sym.Convolution(x, num_filter=width, kernel=kernel,
                        stride=stride, pad=pad,
                        name='conv_%s%s' % (name, suffix))
    return sym.Activation(x, act_type='relu',
                          name='relu_%s%s' % (name, suffix))


def _inception(x, widths, name, pool='max'):
    w1, w3r, w3, w5r, w5, wp = widths
    towers = [
        _conv_relu(x, w1, (1, 1), '%s_1x1' % name),
        _conv_relu(_conv_relu(x, w3r, (1, 1), '%s_3x3' % name,
                              suffix='_reduce'),
                   w3, (3, 3), '%s_3x3' % name, pad=(1, 1)),
        _conv_relu(_conv_relu(x, w5r, (1, 1), '%s_5x5' % name,
                              suffix='_reduce'),
                   w5, (5, 5), '%s_5x5' % name, pad=(2, 2)),
        _conv_relu(sym.Pooling(x, kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), pool_type=pool,
                               name='%s_pool_%s_pool' % (pool, name)),
                   wp, (1, 1), '%s_proj' % name),
    ]
    return sym.Concat(*towers, name='ch_concat_%s_chconcat' % name)


# (module name, tower widths); None rows are stage-boundary max-pools
_MODULES = [
    ('in3a', (64, 96, 128, 16, 32, 32)),
    ('in3b', (128, 128, 192, 32, 96, 64)),
    None,
    ('in4a', (192, 96, 208, 16, 48, 64)),
    ('in4b', (160, 112, 224, 24, 64, 64)),
    ('in4c', (128, 128, 256, 24, 64, 64)),
    ('in4d', (112, 144, 288, 32, 64, 64)),
    ('in4e', (256, 160, 320, 32, 128, 128)),
    None,
    ('in5a', (256, 160, 320, 32, 128, 128)),
    ('in5b', (384, 192, 384, 48, 128, 128)),
]


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable('data')
    x = _conv_relu(x, 64, (7, 7), 'conv1', stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type='max')
    x = _conv_relu(x, 64, (1, 1), 'conv2')
    x = _conv_relu(x, 192, (3, 3), 'conv3', pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type='max')
    for row in _MODULES:
        if row is None:
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type='max')
        else:
            x = _inception(x, row[1], row[0])
    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), pool_type='avg')
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name='softmax')
