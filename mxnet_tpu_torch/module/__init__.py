"""The Module API — the port of ``mxnet_tpu/module`` for one device:
``BaseModule`` (fit/score/predict), ``Module`` and its executor group,
and ``BucketingModule`` (one Module per bucket over shared arrays).
Pipeline, sequential and python modules are not ported."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ['BaseModule', 'BucketingModule', 'Module']
