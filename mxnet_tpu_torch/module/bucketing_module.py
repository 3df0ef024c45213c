"""BucketingModule — variable-length sequence training; the port of
``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``).

One ``Module`` per bucket key, each bound with the default bucket's
module as ``shared_module``: every bucket's executor holds the default
bucket's own parameter, gradient and aux arrays, and borrows its
optimizer.  The fused step updates those tensors and the optimizer state
in place, so the one optimizer-state dict is handed from bucket to
bucket (``_fit_step``), as the reference shared one updater across its
bucket executors.  On the card each bucket module replays its own CUDA
graph over those shared tensors (``Module._step_graph``); every bucket's
graphs share the default bucket's memory pool (they replay on one
stream, never at once) and copy their outputs out of it, so a bucket's
outputs survive another bucket's replay.  ``_warm_start`` under
``MXTPU_PRECOMPILE_BUCKETS`` captures every declared bucket at fit
start, and with ``MXTPU_COMPILE_CACHE`` every bucket an earlier
process's warmup manifest names.

``context`` defaults to ``gpu(0)``, as ``Module``'s does; a context list
and ``work_load_list`` go to every bucket's ``Module`` (one executor per
context; a bucket's executor ``i`` shares the default bucket's executor
``i``'s arrays).  A kvstore comes through ``init_optimizer``: the default
bucket's module makes it, and every bucket borrows it with the optimizer
(``Module.borrow_optimizer``).  Bucketed
training is float32, as in the reference (whose BucketingModule takes no
``compute_dtype``).  ``install_monitor`` taps every bucket's module, the
buckets bound later included (each trains through the loop then; the
reference taps only the buckets bound at the call).

Over a dp×tp mesh (``fit(mesh=...)``, ``_set_parallel``,
``mxnet_tpu/module/bucketing_module.py:51``) every bucket's module takes
the ONE plan the bucketing module made: each binds this rank's rows of
its bucket's batch, and every bucket's fused step updates the shared
parameters through the same ZeRO layout, so the optimizer state handed
from bucket to bucket is this rank's ZeRO part.
"""
from __future__ import annotations

import logging

from .. import config as _config
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ['BucketingModule']


class BucketingModule(BaseModule):
    """(reference bucketing_module.py:20)"""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, bucket_keys=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        # declared bucket keys for MXTPU_PRECOMPILE_BUCKETS: each entry a
        # bare key (shapes derived from the default bucket's, see
        # _derive_bucket_shapes) or a (key, data_shapes, label_shapes)
        # tuple; bound and warmed at fit start
        self._declared_bucket_keys = list(bucket_keys or [])
        self._warm_eager = False
        self._monitor = None
        self._mesh_plan = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        # the shared arrays were rebound: no bucket's graph holds them
        for mod in self._buckets.values():
            mod._drop_graphs()
        self._params_dirty = False
        self.params_initialized = True

    def _new_module(self, bucket_key, made=None):
        symbol, data_names, label_names = made or self._sym_gen(bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list)
        if self._mesh_plan is not None:
            module._set_parallel(self._mesh_plan)
        return module

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        """Bind the default bucket (bucketing_module.py:145).  A rebind
        keeps the trained parameters."""
        assert shared_module is None, \
            'shared_module for BucketingModule is not supported'
        params = None
        if force_rebind:
            if self.binded and self.params_initialized:
                params = self.get_params()
            self._reset_bind()
        if self.binded:
            self.logger.warning('Already binded, ignoring bind()')
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self._warm_eager = bool(self._declared_bucket_keys and
                                _config.get('MXTPU_PRECOMPILE_BUCKETS'))
        if params is not None:
            module.init_params(initializer=None, arg_params=params[0],
                               aux_params=params[1], force_init=True)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None,
                      made=None):
        """Switch to (bind if needed) a bucket (bucketing_module.py:189);
        ``made``: what ``sym_gen(bucket_key)`` returned, when the caller
        has it."""
        assert self.binded, 'call bind before switching bucket'
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._new_module(bucket_key, made)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        shared_module=default)
            module._pool_owner = default
            if self.optimizer_initialized:
                module.borrow_optimizer(default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring.')
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # -- warm start / bucket precompile ------------------------------------
    def _derive_bucket_shapes(self, shapes, key):
        """Per-bucket shapes from the default bucket's bound shapes: the
        default key becomes ``key`` in every non-batch dim (dim 0, the
        batch, is never touched).  None when the convention cannot apply
        (keys that are not ints)."""
        if shapes is None or not (isinstance(key, int) and
                                  isinstance(self._default_bucket_key, int)):
            return None
        return [(name, tuple(shape[:1]) + tuple(
            key if d == self._default_bucket_key else d for d in shape[1:]))
            for name, shape in shapes]

    def _bind_declared_buckets(self):
        """Bind every declared bucket not bound yet (sharing the default
        bucket's arrays), leaving the current bucket as it was."""
        curr_key = self._curr_bucket_key
        default = self._buckets[self._default_bucket_key]
        for declared in self._declared_bucket_keys:
            if isinstance(declared, tuple) and len(declared) == 3:
                key, dshapes, lshapes = declared
            else:
                key = declared
                dshapes = self._derive_bucket_shapes(default.data_shapes, key)
                lshapes = self._derive_bucket_shapes(default.label_shapes,
                                                     key)
            if key in self._buckets:
                continue
            if dshapes is None:
                self.logger.warning(
                    'MXTPU_PRECOMPILE_BUCKETS: cannot derive shapes for '
                    'bucket %r (int keys only; declare (key, data_shapes, '
                    'label_shapes)); it will bind lazily', key)
                continue
            self.switch_bucket(key, dshapes, lshapes)
        curr = self._buckets[curr_key]
        self.switch_bucket(curr_key, curr.data_shapes, curr.label_shapes)

    def _warm_start(self, eval_metric=None, data_sig=None):
        """Warm the default bucket first, then every bucket the warmup
        manifest names (:meth:`_manifest_buckets`), every other bound
        bucket and, under MXTPU_PRECOMPILE_BUCKETS, every declared one:
        each builds its fused step on the shared optimizer state and, on
        the card, captures its graph, on this thread before the first
        batch (counted as ``compile.warmup_traces`` with
        ``MXTPU_COMPILE_CACHE``), so no bucket pays that on its first
        batch."""
        assert self.binded and self.params_initialized
        if self._declared_bucket_keys and \
                _config.get('MXTPU_PRECOMPILE_BUCKETS'):
            self._bind_declared_buckets()
        default = self._buckets[self._default_bucket_key]
        default._warm_start(eval_metric)
        named = self._manifest_buckets()
        if named:
            curr_key = self._curr_bucket_key
            for key, made, dshapes, lshapes in named:
                self.switch_bucket(key, dshapes, lshapes, made=made)
            curr = self._buckets[curr_key]
            self.switch_bucket(curr_key, curr.data_shapes, curr.label_shapes)
        for mod in self._buckets.values():
            if mod is not default:
                mod._fused_opt_state = default._fused_opt_state
                mod._warm_start(eval_metric)

    def _manifest_buckets(self):
        """The buckets not bound yet that the warmup manifest names:
        ``(key, sym_gen(key), data_shapes, label_shapes)`` for each
        ``fit_step`` entry whose batch shapes are the default bucket's
        with the default key replaced by one int key (the convention of
        :meth:`_derive_bucket_shapes`) and whose fingerprint is that
        key's symbol's."""
        from .. import compile_cache
        key0 = self._default_bucket_key
        if not isinstance(key0, int) or compile_cache.cache_dir() is None:
            return []
        default = self._buckets[key0]
        dshapes = list(default.data_shapes)
        lshapes = list(default.label_shapes or [])
        found = {}
        for entry in compile_cache.manifest_entries('fit_step'):
            batch = entry.get('batch') or {}
            if set(batch) != {n for n, _ in dshapes + lshapes}:
                continue
            keys, fits = set(), True
            for name, shape in dshapes + lshapes:
                got = [int(d) for d in batch[name][0]]
                if len(got) != len(shape) or got[0] != shape[0]:
                    fits = False
                    break
                for d, g in zip(shape[1:], got[1:]):
                    if d == key0:
                        keys.add(g)
                    elif d != g:
                        fits = False
            if not fits or len(keys) != 1:
                continue
            key = keys.pop()
            if key in self._buckets or key in found:
                continue
            made = self._sym_gen(key)
            if compile_cache.fingerprint(made[0]) == entry.get('fp'):
                found[key] = (key, made,
                              self._derive_bucket_shapes(dshapes, key),
                              self._derive_bucket_shapes(lshapes, key)
                              if lshapes else None)
        return list(found.values())

    def _device_place_fn(self):
        return self._curr_module._device_place_fn() if self.binded else None

    def _feed_device(self):
        return self._curr_module._feed_device()

    def _fit_step(self, data_batch, eval_metric=None):
        """One fused step on the batch's bucket.  Parameters are shared
        storage, so the optimizer state is too: the default bucket's dict
        goes to the bucket that runs the step (set before its step is
        built, so it never allocates its own) and comes back after it."""
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        curr = self._curr_module
        default = self._buckets[self._default_bucket_key]
        if curr is not default and default._fused_opt_state is not None:
            curr._fused_opt_state = default._fused_opt_state
        handled = curr._fit_step(data_batch, eval_metric)
        if curr is not default and curr._fused_opt_state is not None:
            default._fused_opt_state = curr._fused_opt_state
        self._params_dirty = True
        return handled

    # -- compute -------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def get_input_grads(self, merge_multi_context=True):
        """The current bucket's input gradients
        (bucketing_module.py:300)."""
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def install_monitor(self, mon):
        """Tap every bucket's module, and each bucket bound later
        (bucketing_module.py:319)."""
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def _set_parallel(self, mesh, partition=None):
        """Install the dp×tp plan: one plan for every bucket, the bound
        ones and those bound later (``mxnet_tpu/module/
        bucketing_module.py:51``)."""
        from ..parallel import mesh as _pmesh
        plan = mesh if isinstance(mesh, _pmesh.ShardingPlan) else \
            _pmesh.make_plan(mesh, partition)
        if self._mesh_plan is not None and \
                plan.sig() == self._mesh_plan.sig():
            plan = self._mesh_plan
        self._mesh_plan = plan
        for mod in self._buckets.values():
            mod._set_parallel(plan)

    def _ticket_outputs(self):
        return self._curr_module._ticket_outputs()
