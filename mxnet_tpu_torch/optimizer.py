"""Optimizers — the port of ``mxnet_tpu/optimizer.py`` (``:22-341``,
``:702-773``): the ``Optimizer`` base with its lr/wd multiplier tables,
``SGD`` (momentum, wd, rescale_grad, clip_gradient, multi_precision),
``create``, ``Updater``/``get_updater``, and the functional form the
fused train step applies (``make_functional`` -> ``FunctionalOptimizer``).

The JAX functional update is pure; here ``FunctionalOptimizer.update``
updates the f32 master weights and the optimizer state IN PLACE (same
arithmetic, same order), which saves a copy of every parameter per
step.  Other optimizers are not ported yet.
"""
from __future__ import annotations

import logging

import torch

from .ndarray import zeros

__all__ = ['Optimizer', 'SGD', 'FunctionalOptimizer', 'Updater', 'create',
           'get_updater', 'register']


class Optimizer(object):
    """Base optimizer (reference optimizer.py:13-197)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        assert isinstance(klass, type)
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning('WARNING: New optimizer %s.%s is overriding '
                            'existing optimizer %s.%s', klass.__module__,
                            klass.__name__,
                            Optimizer.opt_registry[name].__module__,
                            Optimizer.opt_registry[name].__name__)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](
                rescale_grad=rescale_grad, **kwargs)
        raise ValueError('Cannot find optimizer %s' % name)

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0,
                 multi_precision=False):
        # multi_precision: optimizer state in float32 for low-precision
        # weights (the fused step's master weights are float32 anyway)
        self.multi_precision = bool(multi_precision)
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            'param_idx2name should be a dict of param indexes to names.'
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Create per-weight state (momentum etc.)."""

    def _state_dtype(self, weight):
        """Per-weight state dtype: the weight's, float32 under
        ``multi_precision``."""
        dt = getattr(weight, 'dtype', weight)
        if self.multi_precision and dt != torch.float32:
            return torch.float32
        return dt

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_mult(self, args_lr_mult):
        """Per-arg lr multipliers from ``__lr_mult__`` attrs
        (optimizer.py:103-125)."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and '__lr_mult__' in attr[name]:
                    self.lr_mult[name] = float(attr[name]['__lr_mult__'])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Defaults: no decay on bias/gamma/beta (optimizer.py:127-155)."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith('_weight') or n.endswith('_gamma')):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and '__wd_mult__' in attr[name]:
                    self.wd_mult[name] = float(attr[name]['__wd_mult__'])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- functional form (Module fused fit path) ---------------------------
    def _name_lr_mult(self, name, index=None):
        """Same resolution order as ``_get_lr``: index key wins, then
        the name key."""
        if index is not None and index in self.lr_mult:
            return float(self.lr_mult[index])
        return float(self.lr_mult.get(name, 1.0))

    def _name_wd_mult(self, name, index=None):
        if index is not None and index in self.wd_mult:
            return float(self.wd_mult[index])
        return float(self.wd_mult.get(name, 1.0))

    def _mult_signature(self):
        """Fingerprint of the multiplier tables: the fused step resolves
        multipliers once and rebuilds when this changes."""
        return (tuple(sorted((repr(k), v)
                             for k, v in self.lr_mult.items())),
                tuple(sorted((repr(k), v)
                             for k, v in self.wd_mult.items())))

    def host_lr(self):
        """Per-step base learning rate (scheduler applied), computed on
        the host."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return float(self.lr)

    def make_functional(self, param_names, param_indices=None):
        """A :class:`FunctionalOptimizer` applying this optimizer's update
        to whole parameter dicts, or None when it has no such form
        (Module then takes the per-parameter updater loop)."""
        return None


class FunctionalOptimizer(object):
    """The optimizer's update over name -> tensor dicts, for the fused
    train step.  ``init(params)`` builds the per-weight state;
    ``update(params, grads, states, lr_t)`` applies one step in place
    given the base lr (post-scheduler, pre-multiplier): a Python float,
    or a 0-dim device tensor the host fills before each step — the
    counterpart of the JAX step's traced ``jnp.float32(host_lr())``
    argument.  A captured step must take the tensor: a float would be
    frozen into the graph at its capture value.  ``update_one(name, w,
    g, state, lr)`` gets the parameter's own lr (base times its
    multiplier)."""

    def __init__(self, opt, param_names, update_one, init_one,
                 param_indices=None):
        self.opt = opt
        self.param_names = list(param_names)
        self._update_one = update_one
        self._init_one = init_one
        idx = param_indices or {}
        self.mult_signature = opt._mult_signature()
        self.lr_mults = {n: opt._name_lr_mult(n, idx.get(n))
                         for n in self.param_names}
        self.wd_mults = {n: opt._name_wd_mult(n, idx.get(n))
                         for n in self.param_names}

    def init(self, params):
        return {n: self._init_one(n, params[n]) for n in self.param_names
                if n in params}

    def update(self, params, grads, states, lr_t):
        """One step, in place on ``params`` and ``states``."""
        lrs = {1.0: lr_t}       # one product per distinct multiplier
        with torch.no_grad():
            for n, w in params.items():
                mult = self.lr_mults[n]
                if mult not in lrs:
                    lrs[mult] = lr_t * mult
                self._update_one(n, w, grads[n].to(w.dtype), states[n],
                                 lrs[mult])


register = Optimizer.register


def _rescale_clip(opt, g):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient >= 0:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py:199-260):
    ``mom = momentum * mom - lr * (rescale_clip(g) + wd * w); w += mom``
    (without momentum ``w -= lr * (g + wd * w)``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context,
                     dtype=self._state_dtype(weight))

    def _step(self, w, g, mom, lr, wd):
        """In place on ``w`` (and ``mom``); ``lr`` a float or a 0-dim
        tensor."""
        g = _rescale_clip(self, g)
        if mom is None:
            w.sub_(lr * (g + wd * w))
            return
        mom.mul_(self.momentum).sub_((lr * (g + wd * w)).to(mom.dtype))
        w.add_(mom.to(w.dtype))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            w = weight.handle.clone()
            mom = None if state is None else state.handle.clone()
            self._step(w, grad.handle.to(w.dtype), mom, lr, wd)
        weight._set_data(w)
        if state is not None:
            state._set_data(mom)

    def make_functional(self, param_names, param_indices=None):
        fn = self

        def init_one(name, w):
            return None if fn.momentum == 0.0 else \
                torch.zeros(w.shape, dtype=fn._state_dtype(w),
                            device=w.device)

        def update_one(name, w, g, s, lr):
            fn._step(w, g, s, lr, fn.wd * fo.wd_mults[name])

        fo = FunctionalOptimizer(self, param_names, update_one, init_one,
                                 param_indices=param_indices)
        return fo


create = Optimizer.create_optimizer


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples, creating
    state lazily (optimizer.py:802-825)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    """(reference optimizer.py:828-833)."""
    return Updater(optimizer)
