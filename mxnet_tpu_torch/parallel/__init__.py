"""Training-step construction (the port of ``mxnet_tpu/parallel``'s
single-device ``train_step.py``; the mesh, ZeRO and collective modules
are not ported)."""
from .train_step import (make_eval_step, make_fit_step, make_sgd_momentum,
                         make_train_step, sgd_momentum_init)

__all__ = ['make_fit_step', 'make_train_step', 'make_eval_step',
           'make_sgd_momentum', 'sgd_momentum_init']
