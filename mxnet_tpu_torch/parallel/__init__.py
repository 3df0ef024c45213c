"""Training-step construction and sequence parallelism (the port of
``mxnet_tpu/parallel``'s ``train_step.py``, ``ring.py`` and ``sp.py``, on
``torch.distributed``; the mesh, ZeRO, pipeline and collective modules
are not ported)."""
from .train_step import (make_eval_step, make_fit_step, make_sgd_momentum,
                         make_train_step, sgd_momentum_init)
from .sp import make_sp_train_step, shard_sp_params

__all__ = ['make_fit_step', 'make_train_step', 'make_eval_step',
           'make_sgd_momentum', 'sgd_momentum_init', 'make_sp_train_step',
           'shard_sp_params']
