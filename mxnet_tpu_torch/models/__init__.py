"""Model zoo of the port — the reference's
example/image-classification/symbols, example/rnn and example/ssd
networks as symbol constructors, by name and alias as in
``mxnet_tpu/models/__init__.py``."""
from . import mlp, lenet, alexnet, vgg, resnet, inception_bn, inception_v3
from . import googlenet, resnext, inception_resnet_v2
from . import lstm_lm
from . import transformer_lm
from . import ssd

_MODELS = {
    'mlp': mlp.get_symbol,
    'lenet': lenet.get_symbol,
    'alexnet': alexnet.get_symbol,
    'vgg': vgg.get_symbol,
    'vgg16': lambda **kw: vgg.get_symbol(num_layers=16, **kw),
    'vgg19': lambda **kw: vgg.get_symbol(num_layers=19, **kw),
    'resnet': resnet.get_symbol,
    'resnet-18': lambda **kw: resnet.get_symbol(num_layers=18, **kw),
    'resnet-34': lambda **kw: resnet.get_symbol(num_layers=34, **kw),
    'resnet-50': lambda **kw: resnet.get_symbol(num_layers=50, **kw),
    'resnet-101': lambda **kw: resnet.get_symbol(num_layers=101, **kw),
    'resnet-152': lambda **kw: resnet.get_symbol(num_layers=152, **kw),
    'inception-bn': inception_bn.get_symbol,
    'inception-v3': inception_v3.get_symbol,
    'inception-resnet-v2': inception_resnet_v2.get_symbol,
    'googlenet': googlenet.get_symbol,
    'resnext': resnext.get_symbol,
    'resnext-50': lambda **kw: resnext.get_symbol(num_layers=50, **kw),
    'resnext-101': lambda **kw: resnext.get_symbol(num_layers=101, **kw),
    'lstm_lm': lstm_lm.get_symbol,
    'transformer_lm': transformer_lm.get_symbol,
    'ssd-vgg16': ssd.get_symbol,
    'ssd-vgg16-train': ssd.get_symbol_train,
}

__all__ = ['mlp', 'lenet', 'alexnet', 'vgg', 'resnet', 'inception_bn',
           'inception_v3', 'googlenet', 'resnext', 'inception_resnet_v2',
           'lstm_lm', 'transformer_lm', 'ssd', 'get_symbol', 'list_models']


def get_symbol(name, **kwargs):
    """Fetch a model symbol by name (train_imagenet.py --network)."""
    if name not in _MODELS:
        raise ValueError('unknown model %r; available: %s'
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)


def list_models():
    return sorted(_MODELS)
