"""Model zoo of the port: the symbol constructors ported so far, by name
as in ``mxnet_tpu/models/__init__.py``."""
from . import alexnet, lenet, mlp
from . import resnet
from . import transformer_lm

_MODELS = {
    'alexnet': alexnet.get_symbol,
    'lenet': lenet.get_symbol,
    'mlp': mlp.get_symbol,
    'resnet': resnet.get_symbol,
    'transformer_lm': transformer_lm.get_symbol,
}

__all__ = ['alexnet', 'lenet', 'mlp', 'resnet', 'transformer_lm',
           'get_symbol', 'list_models']


def get_symbol(name, **kwargs):
    """Fetch a model symbol by name (train_imagenet.py --network)."""
    if name not in _MODELS:
        raise ValueError('unknown model %r; available: %s'
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)


def list_models():
    return sorted(_MODELS)
