"""Weight initializers — the port of ``mxnet_tpu/initializer.py``
(reference ``python/mxnet/initializer.py:253-460``).

Same name-pattern-driven dispatch: an ``Initializer`` is called with
``(name, array)`` and routes on the variable-name suffix
(``_weight``/``_bias``/``_gamma``/``_beta``/``moving_*``; ``upsampling*``
takes the bilinear kernel).  Random draws come from the array's device
generator (``random.py``), except ``Orthogonal``'s, which are numpy's
global generator's, as in the reference.
"""
from __future__ import annotations

import json
import re

import numpy as np

from . import ndarray as nd
from . import random as _random
from .ndarray import NDArray

__all__ = ['InitDesc', 'Initializer', 'Load', 'Mixed', 'Zero', 'One',
           'Constant', 'Uniform', 'Normal', 'Orthogonal', 'Xavier',
           'MSRAPrelu', 'Bilinear', 'FusedRNN', 'create']


class InitDesc(str):
    """Parameter name carrying its variable attributes — lets a
    Variable's ``init=...`` attr (``__init__`` in the symbol attr dict)
    reach the initializer."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


def create(spec):
    """Build an initializer from a dumps() string or registry name."""
    if callable(spec):
        return spec
    try:
        klass, kwargs = json.loads(spec)
        return _INIT_REGISTRY[klass.lower()](**kwargs)
    except (ValueError, KeyError):
        return _INIT_REGISTRY[str(spec).lower()]()


class Initializer(object):
    """Base initializer; routes by name pattern (initializer.py:24-107)."""

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError('name must be string')
        if not isinstance(arr, NDArray):
            raise TypeError('arr must be NDArray')
        # a Variable-level init= attr overrides pattern routing
        init_attr = getattr(name, 'attrs', {}).get('__init__')
        if init_attr:
            create(init_attr)._init_weight(name, arr)
            return
        if name.startswith('upsampling'):
            self._init_bilinear(name, arr)
        elif name.endswith('bias'):
            self._init_bias(name, arr)
        elif name.endswith('gamma'):
            self._init_gamma(name, arr)
        elif name.endswith('beta'):
            self._init_beta(name, arr)
        elif name.endswith('weight'):
            self._init_weight(name, arr)
        elif name.endswith(('moving_mean', 'moving_inv_var', 'moving_avg')):
            self._init_zero(name, arr)
        elif name.endswith('moving_var'):
            self._init_one(name, arr)
        elif 'begin_state' in name:
            self._init_zero(name, arr)
        elif name.endswith('parameters'):
            # a fused RNN's packed blob (FusedRNNCell): one weight init
            # over the whole blob, or FusedRNN per gate matrix
            self._init_weight(name, arr)
        else:
            self._init_default(name, arr)

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(),
                           getattr(self, '_kwargs', {})])

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel over the last two axes
        (initializer.py:75)."""
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        i = np.arange(int(np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        arr[:] = weight.astype('float32').reshape(shape)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError('Must override it')

    def _init_default(self, name, _):
        raise ValueError(
            'Unknown initialization pattern for %s. Default initialization '
            'is now limited to "weight", "bias", "gamma" (1.0), and '
            '"beta" (0.0).' % name)


class Load(object):
    """Init from a params dict (or ``.params`` file), falling back to
    ``default_init`` (initializer.py:110-147)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = nd.load(param)
        self.param = {
            (k[4:] if k.startswith('arg:') or k.startswith('aux:') else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if arr.shape != tuple(self.param[name].shape):
                raise ValueError('Parameter %s cannot be initialized from '
                                 'loading. Shape mismatch, target %s vs '
                                 'loaded %s' % (name, str(arr.shape),
                                                str(self.param[name].shape)))
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise ValueError('Cannot Initialize parameter: %s' % name)
            self.default_init(name, arr)


class Mixed(object):
    """Regex-pattern-routed mix of initializers (initializer.py:150-180)."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError('Parameter name %s did not match any pattern. '
                         'Consider adding a ".*" pattern at the end.' % name)


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value
        self._kwargs = {'value': value}

    def _init_weight(self, _, arr):
        arr[:] = self.value


class Uniform(Initializer):
    """U(-scale, scale) (initializer.py:253)."""

    def __init__(self, scale=0.07):
        self.scale = scale
        self._kwargs = {'scale': scale}

    def _init_weight(self, _, arr):
        _random.uniform(-self.scale, self.scale, out=arr)


class Normal(Initializer):
    """N(0, sigma) (initializer.py:272)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma
        self._kwargs = {'sigma': sigma}

    def _init_weight(self, _, arr):
        _random.normal(0, self.sigma, out=arr)


class Orthogonal(Initializer):
    """An orthogonal matrix, scaled (initializer.py:205): the U or V of
    the SVD of a numpy draw, uniform in [-1, 1) or standard normal."""

    def __init__(self, scale=1.414, rand_type='uniform'):
        self.scale = scale
        self.rand_type = rand_type
        self._kwargs = {'scale': scale, 'rand_type': rand_type}

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == 'uniform':
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * res).reshape(arr.shape)


class Xavier(Initializer):
    """Xavier/Glorot init (initializer.py:325)."""

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)
        self._kwargs = {'rnd_type': rnd_type, 'factor_type': factor_type,
                        'magnitude': magnitude}

    def _init_weight(self, _, arr):
        shape = arr.shape
        hw_scale = 1.
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == 'avg':
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == 'in':
            factor = fan_in
        elif self.factor_type == 'out':
            factor = fan_out
        else:
            raise ValueError('Incorrect factor type')
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == 'uniform':
            _random.uniform(-scale, scale, out=arr)
        elif self.rnd_type == 'gaussian':
            _random.normal(0, scale, out=arr)
        else:
            raise ValueError('Unknown random type')


class MSRAPrelu(Xavier):
    """Kaiming initialization for PReLU nets (initializer.py:259):
    gaussian Xavier of magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type='avg', slope=0.25):
        super().__init__('gaussian', factor_type, 2. / (1 + slope ** 2))
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


class Bilinear(Initializer):
    """Every weight the bilinear upsampling kernel (initializer.py:267)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


class FusedRNN(Initializer):
    """Initialize a fused RNN's packed blob gate matrix by gate matrix
    with ``init``, biases with its bias rule
    (``mxnet_tpu/initializer.py:272``)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional

    def _init_weight(self, _, arr):
        from .rnn.rnn_cell import FusedRNNCell
        cell = FusedRNNCell(self._num_hidden, self._num_layers,
                            self._mode, self._bidirectional)
        args = cell.unpack_weights({cell._parameter.name: arr})
        for name in args:
            if name.split('_')[-1].endswith('weight'):
                self._init._init_weight(name, args[name])
            else:
                self._init._init_bias(name, args[name])
        arr[:] = cell.pack_weights(args)[cell._parameter.name]


_INIT_REGISTRY = {
    'zero': Zero, 'one': One, 'constant': Constant, 'uniform': Uniform,
    'normal': Normal, 'orthogonal': Orthogonal, 'xavier': Xavier,
    'msraprelu': MSRAPrelu, 'bilinear': Bilinear,
}
