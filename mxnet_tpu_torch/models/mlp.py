"""MLP — the port of ``mxnet_tpu/models/mlp.py`` (reference
example/image-classification/symbols/mlp.py)."""
from .. import symbol as sym


def get_symbol(num_classes=10, hidden=(128, 64), **kwargs):
    data = sym.Variable('data')
    net = data
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, name='fc%d' % (i + 1), num_hidden=h)
        net = sym.Activation(net, name='relu%d' % (i + 1), act_type='relu')
    net = sym.FullyConnected(net, name='fc%d' % (len(hidden) + 1),
                             num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name='softmax')
