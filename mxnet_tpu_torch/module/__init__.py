"""The Module API — the port of ``mxnet_tpu/module``: ``BaseModule``
(fit/score/predict, checkpoints), ``Module`` and its executor group (one
executor per context, gradients through the kvstore), ``BucketingModule`` (one Module per bucket over shared
arrays), ``SequentialModule``, ``PythonModule`` and ``PythonLossModule``.
The pipeline module is not ported."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ['BaseModule', 'BatchEndParam', 'BucketingModule', 'Module', 'PythonModule',
           'PythonLossModule', 'SequentialModule']
