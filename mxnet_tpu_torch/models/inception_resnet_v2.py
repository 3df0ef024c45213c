"""Inception-ResNet-v2 (reference
example/image-classification/symbols/inception-resnet-v2.py; Szegedy et
al., arXiv:1602.07261): Inception towers with scaled residual
connections, the reference's (1,7)/(7,1) paddings kept — the port's copy
of ``mxnet_tpu/models/inception_resnet_v2.py``: the same graph and node names, built
through ``mxnet_tpu_torch.symbol``."""
from .. import symbol as sym


def Conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
         with_act=True):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad)
    bn = sym.BatchNorm(conv)
    if with_act:
        return sym.Activation(bn, act_type='relu')
    return bn


def block35(net, input_num_channels, scale=1.0, with_act=True):
    t0 = Conv(net, 32, (1, 1))
    t1 = Conv(Conv(net, 32, (1, 1)), 32, (3, 3), pad=(1, 1))
    t2 = Conv(net, 32, (1, 1))
    t2 = Conv(t2, 48, (3, 3), pad=(1, 1))
    t2 = Conv(t2, 64, (3, 3), pad=(1, 1))
    mixed = sym.Concat(t0, t1, t2)
    out = Conv(mixed, input_num_channels, (1, 1), with_act=False)
    net = net + scale * out
    return sym.Activation(net, act_type='relu') if with_act else net


def block17(net, input_num_channels, scale=1.0, with_act=True):
    t0 = Conv(net, 192, (1, 1))
    t1 = Conv(net, 129, (1, 1))
    t1 = Conv(t1, 160, (1, 7), pad=(1, 2))
    t1 = Conv(t1, 192, (7, 1), pad=(2, 1))
    mixed = sym.Concat(t0, t1)
    out = Conv(mixed, input_num_channels, (1, 1), with_act=False)
    net = net + scale * out
    return sym.Activation(net, act_type='relu') if with_act else net


def block8(net, input_num_channels, scale=1.0, with_act=True):
    t0 = Conv(net, 192, (1, 1))
    t1 = Conv(net, 192, (1, 1))
    t1 = Conv(t1, 224, (1, 3), pad=(0, 1))
    t1 = Conv(t1, 256, (3, 1), pad=(1, 0))
    mixed = sym.Concat(t0, t1)
    out = Conv(mixed, input_num_channels, (1, 1), with_act=False)
    net = net + scale * out
    return sym.Activation(net, act_type='relu') if with_act else net


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable('data')
    net = Conv(data, 32, (3, 3), stride=(2, 2))
    net = Conv(net, 32, (3, 3))
    net = Conv(net, 64, (3, 3), pad=(1, 1))
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                      pool_type='max')
    net = Conv(net, 80, (1, 1))
    net = Conv(net, 192, (3, 3))
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                      pool_type='max')

    t0 = Conv(net, 96, (1, 1))
    t1 = Conv(Conv(net, 48, (1, 1)), 64, (5, 5), pad=(2, 2))
    t2 = Conv(net, 64, (1, 1))
    t2 = Conv(t2, 96, (3, 3), pad=(1, 1))
    t2 = Conv(t2, 96, (3, 3), pad=(1, 1))
    t3 = sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type='avg')
    t3 = Conv(t3, 64, (1, 1))
    net = sym.Concat(t0, t1, t2, t3)

    for _ in range(10):
        net = block35(net, 320, scale=0.17)

    t0 = Conv(net, 384, (3, 3), stride=(2, 2))
    t1 = Conv(net, 256, (1, 1))
    t1 = Conv(t1, 256, (3, 3), pad=(1, 1))
    t1 = Conv(t1, 384, (3, 3), stride=(2, 2))
    t2 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                     pool_type='max')
    net = sym.Concat(t0, t1, t2)

    for _ in range(20):
        net = block17(net, 1088, scale=0.1)

    t0 = Conv(Conv(net, 256, (1, 1)), 384, (3, 3), stride=(2, 2))
    t1 = Conv(Conv(net, 256, (1, 1)), 288, (3, 3), stride=(2, 2))
    t2 = Conv(net, 256, (1, 1))
    t2 = Conv(t2, 288, (3, 3), pad=(1, 1))
    t2 = Conv(t2, 320, (3, 3), stride=(2, 2))
    t3 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                     pool_type='max')
    net = sym.Concat(t0, t1, t2, t3)

    for _ in range(9):
        net = block8(net, 2080, scale=0.2)
    net = block8(net, 2080, with_act=False)

    net = Conv(net, 1536, (1, 1))
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True,
                      pool_type='avg')
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name='softmax')
