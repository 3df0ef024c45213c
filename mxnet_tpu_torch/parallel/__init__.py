"""Training-step construction, the dp×tp mesh and sequence parallelism
(the port of ``mxnet_tpu/parallel``'s ``train_step.py``, ``mesh.py``,
``zero.py``, ``collectives.py``, ``ring.py`` and ``sp.py``, on
``torch.distributed``; the pipeline and MoE modules are not ported)."""
from .train_step import (make_eval_step, make_fit_step, make_sgd_momentum,
                         make_train_step, sgd_momentum_init)
from . import collectives, mesh, zero
from .sp import make_sp_train_step, shard_sp_params

__all__ = ['make_fit_step', 'make_train_step', 'make_eval_step',
           'make_sgd_momentum', 'sgd_momentum_init', 'make_sp_train_step',
           'shard_sp_params', 'collectives', 'mesh', 'zero']
