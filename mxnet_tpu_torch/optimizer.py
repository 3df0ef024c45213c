"""Optimizers — the port of ``mxnet_tpu/optimizer.py``: the
``Optimizer`` base with its lr/wd multiplier tables, ``SGD``, ``NAG``,
``Adam``, ``AdaGrad``, ``RMSProp`` (plain and centered), ``ccSGD``,
``DCASGD``, ``SGLD``, ``AdaDelta`` and ``Test``, ``create``,
``Updater``/``get_updater`` with ``get_states``/``set_states``, and the
functional form the fused train step applies (``make_functional`` ->
``FunctionalOptimizer``).

The imperative ``update`` of SGD, Adam and RMSProp calls the update ops
of ``ops/optim.py``, which write the weight and state in place; NAG's and
AdaGrad's run their functional step on the bound tensors; the others
compose ``nd.*`` arithmetic, as in the reference.  Every loop computes
in the state's dtype and writes the weight back in its own (a float16
weight stays float16, under ``multi_precision`` too; the reference
promotes it, ``mxnet_tpu/optimizer.py:51-62``).  SGD, NAG,
Adam, AdaGrad and RMSProp also have a functional form: the JAX update is
pure, here ``FunctionalOptimizer.update`` updates the f32 master weights
and the optimizer state IN PLACE (same arithmetic, same order), which
saves a copy of every parameter per step and is what a captured step
records.  Its learning rate arrives as a 0-dim device tensor the host
fills before each step, Adam's bias correction folded in
(``Adam.host_lr``): nothing inside the update reads a step count.
DCASGD, SGLD and AdaDelta have none (``make_functional`` returns None,
and ``Module`` trains through the ``Updater`` loop).

``Updater.get_states`` pickles the states (NDArrays pickle as numpy
data and a context); ``set_states`` also reads a file the JAX package
wrote, mapping its ``NDArray`` class to this package's by name.
"""
from __future__ import annotations

import io
import logging
import math
import pickle

import torch

from . import ndarray as nd
from .base import MXNetError
from .ndarray import NDArray, imperative_invoke, zeros
from .ops.optim import _one_minus

__all__ = ['Optimizer', 'SGD', 'NAG', 'Adam', 'AdaGrad', 'RMSProp',
           'ccSGD', 'DCASGD', 'SGLD', 'AdaDelta', 'Test',
           'FunctionalOptimizer', 'Updater', 'create', 'get_updater',
           'register']


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

    @staticmethod
    def state_to_updater(name, state):
        """A functional state as an ``Updater.states`` entry: copies (the
        next step, or a graph's replay, overwrites the state in place),
        tuples kept tuples."""
        if state is None:
            return None
        if isinstance(state, tuple):
            return tuple(NDArray(t.detach().clone()) for t in state)
        return NDArray(state.detach().clone())

    @staticmethod
    def load_state(name, state, entry):
        """Copy an ``Updater.states`` entry INTO the functional state
        tensors (a captured step holds their addresses)."""
        dst = state if isinstance(state, tuple) else (state,)
        src = entry if isinstance(entry, (tuple, list)) else (entry,)
        if state is None and entry is None:
            return
        if state is None or entry is None or len(dst) != len(src) or \
                any(d.shape != tuple(e.shape) for d, e in zip(dst, src)):
            raise MXNetError('optimizer state of %s does not match the '
                             'optimizer: %r against %r' % (
                                 name, _describe(state), _describe(entry)))
        with torch.no_grad():
            for d, e in zip(dst, src):
                d.copy_(e.handle if isinstance(e, NDArray) else e)


def _describe(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_describe(s) for s in state)
    return tuple(state.shape)


register = Optimizer.register


def _rescale_clip(opt, g):
    """The gradient preamble of every update: rescale, then clip unless
    ``clip_gradient`` is None or negative (MXNet's "off", on both
    paths; ROADMAP Queue 3 records the reference's fused path clamping
    at -1)."""
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient >= 0:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


def _nd_rescale_clip(opt, grad):
    """:func:`_rescale_clip` on NDArrays (the composed updates)."""
    grad = grad * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient >= 0:
        grad = nd.clip(grad, a_min=-opt.clip_gradient,
                       a_max=opt.clip_gradient)
    return grad


def _op_clip(value):
    return value if value is not None else -1.0


def _functional(opt, param_names, param_indices, init_one, update_one):
    """A FunctionalOptimizer whose ``update_one(name, w, g, s, lr)``
    closes over ``wd`` times the parameter's multiplier."""
    fo = FunctionalOptimizer(
        opt, param_names,
        lambda n, w, g, s, lr: update_one(w, g, s, lr,
                                          opt.wd * fo.wd_mults[n]),
        lambda n, w: init_one(w), param_indices=param_indices)
    return fo


def _zeros_like(opt, w):
    return torch.zeros(w.shape, dtype=opt._state_dtype(w), device=w.device)


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py:199-260):
    ``mom = momentum * mom - lr * (rescale_clip(g) + wd * w); w += mom``
    (without momentum ``w -= lr * (g + wd * w)``), imperatively through
    the ``sgd_update``/``sgd_mom_update`` ops."""

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
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=_op_clip(self.clip_gradient))
        if state is not None:
            imperative_invoke('sgd_mom_update', weight, grad, state,
                              out=[weight, state], momentum=self.momentum,
                              **kwargs)
        else:
            imperative_invoke('sgd_update', weight, grad, out=weight,
                              **kwargs)

    def make_functional(self, param_names, param_indices=None):
        return _functional(
            self, param_names, param_indices,
            lambda w: None if self.momentum == 0.0 else _zeros_like(self, w),
            self._step)


@register
class ccSGD(SGD):
    """The reference's alias of SGD (optimizer.py:450)."""


@register
class NAG(SGD):
    """Nesterov accelerated SGD (optimizer.py:381): ``g += wd * w;
    mom = momentum * mom + g; w -= lr * (g + momentum * mom)``."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        w = weight.handle
        with torch.no_grad():
            self._nag_step(w, grad.handle.to(w.dtype),
                           None if state is None else state.handle, lr, wd)

    def _nag_step(self, w, g, mom, lr, wd):
        g = _rescale_clip(self, g)
        if mom is None:
            w.sub_(lr * (g + wd * w))
            return
        g = g + wd * w
        mom.mul_(self.momentum).add_(g)
        w.sub_(lr * (g + self.momentum * mom))

    def make_functional(self, param_names, param_indices=None):
        return _functional(
            self, param_names, param_indices,
            lambda w: None if self.momentum == 0.0 else _zeros_like(self, w),
            self._nag_step)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (optimizer.py:344); imperative only."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, weight.context,
                      dtype=self._state_dtype(weight)), weight.copy())

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _nd_rescale_clip(self, grad)
        mom, previous_weight = state
        if mom:
            mom *= self.momentum
            mom += -lr * (grad + wd * weight + self.lamda
                          * grad * grad * (weight - previous_weight))
        else:
            assert self.momentum == 0.0
            mom = -lr * (grad + wd * weight + self.lamda
                         * grad * grad * (weight - previous_weight))
        previous_weight[:] = weight
        # rebound, not written in place: previous_weight shares the tensor
        weight._set_data((weight + mom).handle.to(weight.handle.dtype))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (optimizer.py:429); the noise
    comes from the weight's device generator.  Imperative only."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        from . import random as _random
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _nd_rescale_clip(self, grad)
        noise = _random.normal(0, math.sqrt(lr), shape=weight.shape,
                               ctx=weight.context)
        weight._set_data((weight + (- lr / 2 * (grad + wd * weight))
                          + noise).handle.to(weight.handle.dtype))


@register
class Adam(Optimizer):
    """Adam (optimizer.py:455), imperatively through ``adam_update`` with
    the bias correction ``sqrt(1 - beta2^t) / (1 - beta1^t)`` folded into
    the lr; the fused form gets it in :meth:`host_lr`."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        dtype = self._state_dtype(weight)
        return (zeros(weight.shape, weight.context, dtype=dtype),
                zeros(weight.shape, weight.context, dtype=dtype))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        mean, var = state
        lr = self._corrected(lr, self._index_update_count[index])
        imperative_invoke('adam_update', weight, grad, mean, var,
                          out=[weight, mean, var], lr=lr, wd=wd,
                          beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.epsilon,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=_op_clip(self.clip_gradient))

    def host_lr(self):
        """The scheduler's lr with the bias correction folded in, ``t``
        the update count after this step's increments (optimizer.py:488):
        the fused step's lr tensor carries it, so a captured step never
        reads ``t``."""
        return self._corrected(super().host_lr(), max(self.num_update, 1))

    def _corrected(self, lr, t):
        """``lr`` with the bias correction of step ``t``; one expression
        for both forms, so the loop and the fused step get the same lr."""
        return lr * math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)

    def _adam_step(self, w, g, s, lr, wd):
        g = _rescale_clip(self, g) + wd * w
        mean, var = s
        mean.mul_(self.beta1).add_(_one_minus(self.beta1) * g)
        var.mul_(self.beta2).add_(_one_minus(self.beta2) * torch.square(g))
        w.sub_(lr * mean / (torch.sqrt(var) + self.epsilon))

    def make_functional(self, param_names, param_indices=None):
        return _functional(
            self, param_names, param_indices,
            lambda w: (_zeros_like(self, w), _zeros_like(self, w)),
            self._adam_step)


@register
class AdaGrad(Optimizer):
    """AdaGrad (optimizer.py:522): ``h += g^2;
    w -= lr * (g / sqrt(h + eps) + wd * w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context,
                     dtype=self._state_dtype(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        w = weight.handle
        with torch.no_grad():
            self._adagrad_step(w, grad.handle.to(w.dtype), state.handle, lr,
                               wd)

    def _adagrad_step(self, w, g, history, lr, wd):
        g = _rescale_clip(self, g)
        history.add_(torch.square(g))
        w.sub_(lr * (g / torch.sqrt(history + self.float_stable_eps)
                     + wd * w))

    def make_functional(self, param_names, param_indices=None):
        return _functional(self, param_names, param_indices,
                           lambda w: _zeros_like(self, w),
                           self._adagrad_step)


@register
class RMSProp(Optimizer):
    """RMSProp (optimizer.py:573); ``centered=True`` is Alex Graves'
    variant, three states (n, g, delta), through ``rmspropalex_update``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        dtype = self._state_dtype(weight)
        return tuple(zeros(weight.shape, weight.context, dtype=dtype)
                     for _ in range(3 if self.centered else 1))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, gamma1=self.gamma1,
                      epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                      clip_gradient=_op_clip(self.clip_gradient),
                      clip_weights=_op_clip(self.clip_weights))
        if not self.centered:
            (n,) = state
            imperative_invoke('rmsprop_update', weight, grad, n,
                              out=[weight, n], **kwargs)
        else:
            n, g, delta = state
            imperative_invoke('rmspropalex_update', weight, grad, n, g,
                              delta, out=[weight, n, g, delta],
                              gamma2=self.gamma2, **kwargs)

    def _rmsprop_step(self, w, g, s, lr, wd):
        g = _rescale_clip(self, g) + wd * w
        n = s[0]
        n.mul_(self.gamma1).add_(_one_minus(self.gamma1) * torch.square(g))
        if not self.centered:
            w.sub_(lr * g / torch.sqrt(n + self.epsilon))
        else:
            _, mg, delta = s
            mg.mul_(self.gamma1).add_(_one_minus(self.gamma1) * g)
            delta.mul_(self.gamma2).sub_(lr * g / torch.sqrt(
                n - torch.square(mg) + self.epsilon))
            w.add_(delta)
        if self.clip_weights is not None and self.clip_weights > 0:
            w.clamp_(-self.clip_weights, self.clip_weights)

    def make_functional(self, param_names, param_indices=None):
        return _functional(
            self, param_names, param_indices,
            lambda w: tuple(_zeros_like(self, w)
                            for _ in range(3 if self.centered else 1)),
            self._rmsprop_step)


@register
class AdaDelta(Optimizer):
    """AdaDelta (optimizer.py:656); imperative only."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        grad = _nd_rescale_clip(self, grad)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1. - self.rho) * grad * grad
        current_delta = (nd.sqrt(acc_delta + self.epsilon)
                         / nd.sqrt(acc_g + self.epsilon)) * grad
        acc_delta[:] = (self.rho * acc_delta
                        + (1. - self.rho) * current_delta * current_delta)
        weight[:] -= current_delta + wd * weight


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += g * rescale; state = w``."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        weight[:] += grad * self.rescale_grad
        state[:] = weight


create = Optimizer.create_optimizer


class _StatesUnpickler(pickle.Unpickler):
    """Reads a pickled ``Updater.states`` written by either package: the
    JAX package's ``NDArray`` global is mapped, by name, to this
    package's (the port imports nothing of the JAX package)."""

    _CLASSES = {('mxnet_tpu.ndarray', 'NDArray'): NDArray}

    def find_class(self, module, name):
        cls = self._CLASSES.get((module, name))
        if cls is not None:
            return cls
        return super().find_class(module, name)


def loads_states(data):
    """Unpickle ``Updater.states`` bytes (see :class:`_StatesUnpickler`)."""
    return _StatesUnpickler(io.BytesIO(data)).load()


def _place(state, ctx):
    """``state`` (NDArray, tuple, None) on ``ctx``."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_place(s, ctx) for s in state)
    return state.as_in_context(ctx) if isinstance(state, NDArray) else state


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples, creating
    state lazily (optimizer.py:702-773).  State restored by
    :meth:`set_states` moves to its weight's device at the first
    update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._placed = set()

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self._placed.add(index)
        if index not in self._placed:
            self.states[index] = _place(self.states[index], weight.context)
            self._placed.add(index)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Load pickled states (:meth:`get_states` bytes, or the JAX
        package's)."""
        self.states = loads_states(states)
        self._placed = set()

    def get_states(self):
        """The states, pickled (NDArrays pickle whole)."""
        return pickle.dumps(self.states)


def get_updater(optimizer):
    """(reference optimizer.py:828-833)."""
    return Updater(optimizer)
