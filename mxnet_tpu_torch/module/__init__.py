"""The Module API — the port of ``mxnet_tpu/module`` for one device:
``BaseModule`` (fit/score/predict), ``Module`` and its executor group.
Bucketing, pipeline, sequential and python modules are not ported."""
from .base_module import BaseModule
from .module import Module

__all__ = ['BaseModule', 'Module']
