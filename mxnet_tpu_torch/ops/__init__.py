"""Operator registry and the op families of the ported slice.

Importing this package registers every ported operator.
"""
from .registry import get_op, list_ops, register, register_simple, alias, OpDef
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import fused  # noqa: F401
from . import fused_conv  # noqa: F401
from . import attention  # noqa: F401
from . import optim  # noqa: F401
from . import rnn_op  # noqa: F401
from . import vision  # noqa: F401
from . import multibox  # noqa: F401
from . import ctc  # noqa: F401

__all__ = ['get_op', 'list_ops', 'register', 'register_simple', 'alias',
           'OpDef']
