"""Operator registry — the single source of truth for all ops.

The port's copy of ``mxnet_tpu/ops/registry.py``.  Each op registers ONE
function over ``torch.Tensor`` inputs that runs on whatever device the
tensors live on.

Every op is an :class:`OpDef` with a canonical internal signature::

    apply(attrs, inputs, is_train, rng) -> (outputs, aux_updates)

- ``attrs``: dict of python-typed attributes (string forms are parsed once).
- ``inputs``: list of tensors — data inputs first, then parameters
  (weights), then auxiliary states (e.g. BatchNorm moving stats).
- ``outputs``: list of tensors, length ``num_outputs``.
- ``aux_updates``: dict aux-name -> new value (empty for stateless ops).

Shape inference runs ``apply`` on ``meta`` tensors (symbol.py), so op
implementations can never disagree with their shape functions.  An op
with no input (a constant or a sampler) makes its output on the device
its ``ctx`` attr names; the executor passes the device the graph runs
on.  ``rng`` is unused: sampling ops draw from the per-device
``torch.Generator`` of ``random.py``.  Ops
whose parameter shapes depend on data shapes (FullyConnected,
Convolution, ...) additionally provide ``complete_shapes``; an op that
runs user code (``Custom``) provides ``infer_outputs`` instead of being
run on meta tensors.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional

__all__ = ['OpDef', 'register', 'register_simple', 'get_op', 'list_ops',
           'alias']

_REGISTRY: Dict[str, 'OpDef'] = {}
_ALIASES: Dict[str, str] = {}


def parse_attr(value):
    """Parse a possibly-string attribute into a python value.

    Symbol JSON round-trips attrs as strings; accept both forms.
    """
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low in ('True', 'true'):
        return True
    if low in ('False', 'false'):
        return False
    if low == 'None':
        return None
    # NB: the literal string 'null' is a legal enum value (SoftmaxOutput
    # normalization='null') and must NOT collapse to None
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        return value


def parse_attrs(attrs: dict) -> dict:
    return {k: parse_attr(v) for k, v in attrs.items()}


class OpDef:
    """One registered operator."""

    def __init__(self, name, apply_fn, *,
                 input_names: Callable[[dict], List[str]],
                 num_outputs: Callable[[dict], int],
                 aux_names: Callable[[dict], List[str]] = lambda a: [],
                 complete_shapes: Optional[Callable] = None,
                 output_names: Optional[Callable[[dict], List[str]]] = None,
                 takes_rng: bool = False,
                 attr_defaults: Optional[dict] = None,
                 hint: Optional[str] = None,
                 input_var_attrs: Optional[Callable] = None,
                 aux_shape: Optional[Callable] = None,
                 arg_order: Optional[List[str]] = None,
                 infer_outputs: Optional[Callable] = None,
                 out_in_place: bool = False,
                 doc: str = ''):
        self.name = name
        self.apply = apply_fn
        self.input_names = input_names
        self.num_outputs = num_outputs
        self.aux_names = aux_names
        self.complete_shapes = complete_shapes
        self.output_names = output_names or (
            lambda attrs: ['output'] if num_outputs(attrs) == 1
            else ['output%d' % i for i in range(num_outputs(attrs))])
        self.takes_rng = takes_rng
        # (attrs, input_name) -> dict of symbol attrs stamped on
        # auto-created input variables
        self.input_var_attrs = input_var_attrs
        # (attrs, main_in_shapes) -> list of aux shapes, overriding the
        # infer fallback that assumes aux dims track input[0]'s channel
        # count (wrong for the folded conv-bn op, whose aux sizes follow
        # num_filter)
        self.aux_shape = aux_shape
        self.attr_defaults = attr_defaults or {}
        # positional-attr contract of the imperative layer (nd.clip(x,
        # a_min, a_max)): trailing non-array positionals map onto attrs
        # in this order, attr_defaults' order unless given
        self.arg_order = list(arg_order) if arg_order is not None \
            else list(self.attr_defaults)
        # (attrs, in_shapes, in_dtypes) -> [(shape, dtype)] per output,
        # for an op whose apply runs user code that shape inference must
        # not call on meta tensors (Custom, operator.py)
        self.infer_outputs = infer_outputs
        # the imperative layer writes this op's results INTO the arrays
        # of ``out=`` (their tensors), not by swapping the handles: the
        # optimizer updates (ops/optim.py) write the weight and state
        # tensors an Updater holds
        self.out_in_place = out_in_place
        self.hint = hint or name.lower().lstrip('_')
        self.doc = doc

    def canon_attrs(self, attrs: dict) -> dict:
        out = dict(self.attr_defaults)
        out.update(parse_attrs(attrs))
        return out

    def __repr__(self):
        return 'OpDef(%s)' % self.name


def register(name, apply_fn, **kwargs):
    op = OpDef(name, apply_fn, **kwargs)
    if name in _REGISTRY:
        raise ValueError('duplicate op registration: %s' % name)
    _REGISTRY[name] = op
    return op


def register_simple(name, fn, *, ninputs=1, noutputs=1, input_names=None,
                    attr_defaults=None, takes_rng=False, hint=None,
                    arg_order=None, out_in_place=False, doc=''):
    """Register a stateless op from a plain ``fn(*inputs, **attrs)``."""
    if input_names is None:
        input_names = (['data'] if ninputs == 1 else
                       ['lhs', 'rhs'] if ninputs == 2 else
                       ['arg%d' % i for i in range(ninputs)])

    def apply_fn(attrs, inputs, is_train, rng):
        kw = dict(attrs)
        if takes_rng:
            kw['rng'] = rng
        out = fn(*inputs, **kw)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return outs, {}

    return register(
        name, apply_fn,
        input_names=lambda attrs, _n=tuple(input_names): list(_n),
        num_outputs=lambda attrs, _k=noutputs: _k,
        attr_defaults=attr_defaults, takes_rng=takes_rng, hint=hint,
        arg_order=arg_order, out_in_place=out_in_place, doc=doc)


def alias(new_name, existing):
    """Register ``new_name`` as an alias of an existing op."""
    _ALIASES[new_name] = existing


def get_op(name) -> OpDef:
    if name in _ALIASES:
        name = _ALIASES[name]
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError('operator %r is not registered '
                       '(have %d ops)' % (name, len(_REGISTRY))) from None


def list_ops() -> List[str]:
    return sorted(list(_REGISTRY) + list(_ALIASES))
