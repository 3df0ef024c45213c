"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same public surface and
the same symbol JSON and ``.params`` formats, for an NVIDIA H100.  It
serves (``ModelServer`` -> ``Predictor`` -> ``Symbol.bind`` ->
``Executor.forward``) and trains (``Module.fit`` or
``parallel.make_train_step`` -> the fused train step: forward, backward,
SGD-momentum update), both through the ``MXTPU_FUSE`` pass pipeline,
over the ops ResNet-50 v2 and the transformer LM need; variable-length
sequences train through ``mod.BucketingModule`` over
``rnn.BucketSentenceIter``, and long ones with the sequence dimension
sharded over ranks (``parallel.make_sp_train_step``, ring or Ulysses
attention on ``torch.distributed``).  Users extend it
as in the reference: the imperative ``nd.*`` layer over every registered
op, Custom operators (``operator``) and runtime-compiled CUDA kernels
(``rtc.Rtc``, on NVRTC).  Data-parallel training goes through the
kvstore, as in the reference: a context list (one executor per context)
over ``kv.create('local')``/``'device'``, and workers started by
``tools/launch.py`` over ``'dist_sync'`` (``torch.distributed``) or
``'dist_async'`` (the apply-on-arrival server); ``Module.fit(mesh=,
partition=)`` trains over a dp×tp mesh of ranks (one process per mesh
position: the batch split over dp, parameters tp-sharded, optimizer state
ZeRO-sharded, BatchNorm over the global batch); a served model shards
over a dp×tp grid of devices in one process (``Predictor(mesh=,
partition=, devices=)``, ``ModelServer.load_model(mesh=)``), and a bound
symbol places its ``ctx_group``s on devices of their own (``group2ctx``).
Training runs the whole lifecycle: the
reference's optimizers and their update ops, checkpoints of parameters
and optimizer state, ``fit``'s per-epoch checkpoint and auto-resume,
the checkpoint callbacks and the ``FeedForward`` estimator, with
monitors (``monitor.Monitor``), backward mirroring
(``MXNET_BACKWARD_DO_MIRROR``) and the reference's data iterators, the
image pipeline among them (``recordio``, ``io.ImageRecordIter`` over a
native JPEG decode-and-augment library, ``image``, ``opencv``).  The TPU
kernels — ``fused_bn_relu``,
``fused_scale_bias_dot``, ``fused_scale_bias_conv3x3``,
``fused_dot_epilogue``, ``flash_attention`` and ``Rtc`` — are CUDA C++
for sm_90a (``csrc/``).  On the card each fit step, LM train step and
served bucket forward is captured once per batch signature as a CUDA
graph and replayed (``compile_cache.CapturedStep``); under
``MXNET_ENGINE_TYPE=NaiveEngine`` every step runs eagerly.

The package imports torch and numpy, never jax and nothing of
``mxnet_tpu``.  Entry points run on the card unless the caller asks for
the CPU (``dev_type='cpu'`` / ``ctx=cpu()``).

>>> import mxnet_tpu_torch as mx
>>> net = mx.models.resnet.get_symbol(num_classes=10, num_layers=50)
"""
from . import base, config, context, engine, instrument
from . import ops
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import executor, fuse, compile_cache, convert, models
from . import random
from . import operator, rtc
from . import (callback, initializer, io, lr_scheduler, metric, module,
               optimizer, parallel, resilience, rnn)
from . import model, monitor
from . import kvstore, kvstore_server
from . import kvstore as kv
from . import chronicle, commwatch, detector, health, iowatch, perfwatch
from . import initializer as init
from . import module as mod
from . import optimizer as opt
from . import fs, recordio, image
from .base import AttrScope, MXNetError
from .context import Context, cpu, current_context, gpu
from .model import FeedForward
from .module import Module
from .predictor import Predictor
from . import serving

# the reference's import-time engine knob (docs/how_to/env_var.md)
if config.get('MXNET_ENGINE_TYPE') != 'ThreadedEnginePerDevice':
    engine.set_engine_type(config.get('MXNET_ENGINE_TYPE'))

__all__ = ['MXNetError', 'Context', 'cpu', 'gpu', 'current_context',
           'nd', 'sym', 'operator', 'rtc', 'Predictor', 'serving', 'models', 'convert',
           'fuse', 'ops', 'config', 'instrument', 'Module', 'module', 'mod',
           'io', 'metric', 'optimizer', 'lr_scheduler', 'initializer',
           'opt', 'init', 'callback', 'random', 'parallel', 'rnn',
           'engine', 'model', 'FeedForward', 'resilience', 'monitor',
           'detector', 'health', 'iowatch', 'perfwatch', 'commwatch',
           'chronicle', 'fs', 'recordio', 'image', 'AttrScope',
           'kv', 'kvstore', 'kvstore_server']

