"""Module — symbol + executor group + optimizer wiring; the port of
``mxnet_tpu/module/module.py`` for one device (reference
``python/mxnet/module/module.py:323-567``).

``context`` defaults to ``gpu(0)``: the port trains on the card unless
the caller asks for the CPU (``context=cpu()``), and without a CUDA
device a default Module raises (the JAX Module defaults to the current
context; the difference is deliberate, as for ``Predictor``).

The fit loop's step is the fused train step (``_fit_step`` ->
``_try_build_fused`` / ``_run_fused``, ``parallel/train_step.py``):
forward, backward and every parameter update in one call, with the
metric's device form folded in.  It needs a functional optimizer and
``grad_req='write'``, and falls back to ``forward_backward(); update()``
(the per-parameter ``Updater`` loop) otherwise.  ``compute_dtype``
(e.g. ``torch.bfloat16``) casts params and data for the fused
forward/backward, but never an input the graph reads only as an index
(token ids; ``parallel.train_step.index_inputs``); master weights and
optimizer state stay float32.

``bind(shared_module=...)`` and ``borrow_optimizer`` are the bucketing
hooks (``module/bucketing_module.py``): the bound module takes the shared
module's parameter, gradient and aux arrays and, once borrowed, its
optimizer (one update count and lr schedule for every bucket).

Whole-step capture (``mxnet_tpu/module/module.py:809-950``, the AOT
table keyed by ``compile_cache.batch_sig``): ``_run_fused`` copies the
batch into the bound arrays, fills the lr tensor and runs the
``compile_cache.CapturedStep`` of the batch's signature — made on a
miss, whose first step runs eagerly and then records the CUDA graph,
and replayed after that.  The graphs of a module (and of every bucket
of a ``BucketingModule``) share one memory pool and copy their outputs
out of it.  ``_warm_start`` builds the fused step before the first batch
and on the card captures the bound signature (a warm-up step whose
effects on parameters, aux, optimizer state, metric and generator are
undone).  A graph holds raw addresses, so anything that rebinds a
parameter, aux or optimizer-state tensor drops the module's graphs
(``_drop_graphs``), and a graph whose tensors were rebound another way
is not replayed (``CapturedStep.holds``).

Checkpoints (``mxnet_tpu/module/module.py:139-166, 778-807, 1119-1140``):
``Module.load`` reads a ``save_checkpoint`` (and with
``load_optimizer_states`` the ``.states`` file, applied at
``init_optimizer``).  The fused step's optimizer state lives in the
step's own tensors, not in the ``Updater``: ``save_optimizer_states``
first copies it out (``_sync_fused_states_to_updater``, after the step
window drains), and ``load_optimizer_states`` copies the loaded values
INTO those tensors (``_overlay_updater_states``), so the module's graphs
stay valid.  ``MXTPU_FUSED_FIT=0`` trains through the ``Updater`` loop, and so does a
module with a monitor installed (``install_monitor``, as
``mxnet_tpu/module/module.py:604-606`` does): its step stays eager, by
rule, counted in ``compile.capture_skipped``.  kvstores, context lists
and meshes are not ported.
"""
from __future__ import annotations

import functools
import logging

import torch

from .. import compile_cache, instrument, resilience
from .. import config as _config
from .. import health as _health
from .. import perfwatch as _perfwatch
from .. import random as _random
from .. import optimizer as opt
from ..base import MXNetError, resolve_dtype
from ..context import Context, gpu
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray, zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ['Module']


class Module(BaseModule):
    """(reference module.py:323)"""

    def __init__(self, symbol, data_names=('data',),
                 label_names=('softmax_label',), logger=logging,
                 context=None, fixed_param_names=None, compute_dtype=None):
        super().__init__(logger=logger)
        self._compute_dtype = None if compute_dtype is None \
            else resolve_dtype(compute_dtype)
        if context is None:
            context = gpu(0)
        if isinstance(context, Context):
            context = [context]
        for c in context:
            c.torch_device      # raises now when the device is absent
        self._context = context

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, 'data', True)
        _check_input_names(symbol, label_names, 'label', False)
        _check_input_names(symbol, self._fixed_param_names, 'fixed_param',
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        # the module whose graph pool this one's graphs share (a
        # BucketingModule's bucket points at the default bucket)
        self._pool_owner = None
        self._graph_pool = None
        self._reset_fused()

    def _reset_fused(self):
        self._fused = None
        self._fused_unavailable = False
        self._fused_trainable = None
        self._fused_frozen = None
        self._functional_opt = None
        self._fused_opt_state = None
        self._fused_metric = None
        self._lr_t = None
        # the health probe folded into the fused step (None: none) and
        # the fit's monitor whose state buffers the step folds into
        self._fused_health_key = None
        self._health_ref = None
        self._drop_graphs()

    def _drop_graphs(self):
        """Forget every captured step (a graph holds raw addresses) and
        the batch buffers of each signature."""
        self._graphs = {}
        self._sig_batches = {}

    # -- persistence -------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over checkpoint ``prefix``/``epoch`` (module.py:139);
        ``kwargs`` go to the constructor (``context`` defaults to the
        card).  The ``.states`` file, when asked for, is read at
        ``init_optimizer``.  The update count is not restored: a resumed
        fit's Adam ``t`` and lr schedule start again from
        ``begin_num_update``, as in the reference."""
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(symbol=symbol, **kwargs)
        mod._arg_params = arg_params
        mod._aux_params = aux_params
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = '%s-%04d.states' % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, when asked,
        ``prefix-%04d.states``, each committed atomically
        (module.py:152); counts ``checkpoint.commits``."""
        from .. import resilience
        with resilience.atomic_replace('%s-symbol.json' % prefix) as tmp:
            self._symbol.save(tmp)
        param_name = '%s-%04d.params' % (prefix, epoch)
        self.save_params(param_name)
        instrument.inc('checkpoint.commits')
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = '%s-%04d.states' % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def save_optimizer_states(self, fname):
        """Pickle the optimizer state (``Updater.get_states``), the fused
        step's copied out first, committed atomically (module.py:1119)."""
        from .. import resilience
        assert self.optimizer_initialized
        self._sync_fused_states_to_updater()
        with resilience.atomic_replace(fname) as tmp:
            with open(tmp, 'wb') as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Load a ``.states`` file (either package's) into the Updater and,
        when the fused step has state, into its tensors in place
        (module.py:1131)."""
        assert self.optimizer_initialized
        with open(fname, 'rb') as f:
            self._updater.set_states(f.read())
        if self._fused_opt_state is not None:
            self._overlay_updater_states()

    def _sync_fused_states_to_updater(self):
        """Copy the fused step's optimizer state into ``Updater.states``
        (module.py:798), after every step in flight has finished: the
        next step, or a graph's replay, overwrites it in place."""
        if self._fused_opt_state is None or self._updater is None:
            return
        self._drain_window()
        for idx, name in enumerate(self._param_names):
            if name in self._fused_opt_state:
                self._updater.states[idx] = \
                    self._functional_opt.state_to_updater(
                        name, self._fused_opt_state[name])

    def _overlay_updater_states(self):
        """Copy ``Updater.states`` into the fused step's optimizer-state
        tensors, in place (module.py:778): a captured step holds their
        addresses."""
        upd = self._updater
        if upd is None or not upd.states or self._fused_opt_state is None:
            return
        for idx, name in enumerate(self._param_names):
            entry = upd.states.get(idx)
            if name in self._fused_opt_state and entry is not None:
                self._functional_opt.load_state(
                    name, self._fused_opt_state[name], entry)

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(name, shape)]`` of the outputs at the bound shapes."""
        assert self.binded
        shapes = dict(self._data_shapes)
        shapes.update(dict(self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- params ------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._drain_window()
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """(reference module.py:193)"""
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        exec_ = self._exec_group.execs[0]
        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {n: zeros(exec_.arg_dict[n].shape, ctx)
                                for n in self._param_names
                                if n in exec_.arg_dict}
        if self._aux_params is None:
            self._aux_params = {n: zeros(exec_.aux_dict[n].shape, ctx)
                                for n in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            desc = InitDesc(name, attrs.get(name))
            if cache is not None:
                if name in cache:
                    if cache[name] is not arr:
                        arr[:] = cache[name]
                    return
                if not allow_missing:
                    raise RuntimeError('%s is not presented' % name)
                if initializer is None:
                    return
            initializer(desc, arr)

        for name, arr in self._arg_params.items():
            _impl(name, arr, arg_params)
        for name, arr in self._aux_params.items():
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)
        self._drop_graphs()

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        """(reference module.py:388)"""
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._reset_fused()
        if self.binded:
            self.logger.warning('Already binded, ignoring bind()')
            return
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        if not for_training:
            assert not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        self._label_shapes = [(n, tuple(s)) for n, s in label_shapes] \
            if label_shapes is not None else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind at new input shapes, keeping the parameters
        (module.py:326); the fused step captures the new signature at
        its first step."""
        assert self.binded
        self._data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        self._label_shapes = [(n, tuple(s)) for n, s in label_shapes] \
            if label_shapes is not None else None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        """(reference module.py:459).  On one device the reference uses
        no kvstore for ``'local'``/``'device'``/None; a distributed store
        is not ported."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, '
                                'ignoring...')
            return
        if kvstore is not None and not (isinstance(kvstore, str) and
                                        'dist' not in kvstore):
            raise NotImplementedError('kvstore %r is not ported to '
                                      'mxnet_tpu_torch yet' % (kvstore,))
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault('rescale_grad', rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError('optimizer must be a name or an Optimizer')
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._reset_fused()
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """(reference module.py:701) Use ``shared_module``'s optimizer and
        updater: one update count and lr schedule for every bucket.  The
        fused step is rebuilt for it; its optimizer state is the bucketing
        module's to share."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._reset_fused()

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self._exec_group.forward_backward(data_batch)

    def update(self):
        """(reference module.py:551 -> model.py:88-131): the updater on
        every parameter with a gradient."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        exec_ = self._exec_group.execs[0]
        for idx, name in enumerate(self._param_names):
            if name in exec_.grad_dict:
                self._updater(idx, exec_.grad_dict[name],
                              exec_.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        """(module.py:1097)"""
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Tap the executor's forwards (module.py:1110).  The fused step
        is dropped: a monitored module trains through the loop (forward,
        backward, update), eagerly."""
        assert self.binded
        self._fused = None
        self._fused_unavailable = True
        self._drop_graphs()
        self._exec_group.install_monitor(mon)
        compile_cache.note_skip('fit_step', 'monitor')

    # -- fused fit path ----------------------------------------------------
    def _device_metric(self, eval_metric):
        """The metric to fold into the fused step, or None for the
        host-side path (no device form, several labels or outputs)."""
        if eval_metric is None or len(self._label_names) != 1 or \
                len(self._output_names) != 1:
            return None
        return eval_metric if eval_metric.device_capable() else None

    def _device_place_fn(self):
        return self._exec_group._place_data if self.binded else None

    def _feed_device(self):
        return self._context[0].torch_device

    def _fit_step(self, data_batch, eval_metric=None):
        """One fit-loop step: forward + backward + every parameter update
        through the fused step (``mxnet_tpu/module/module.py:593``), the
        metric folded in when it has a device form (returns True then)
        and, with ``MXTPU_HEALTH_SENTINELS``, the health probe.  Falls
        back to ``forward_backward(); update()`` when the step cannot be
        built (non-functional optimizer, a ``grad_req`` other than
        'write', inputs that need gradients, a monitor installed).

        The probe is baked into the step, as the reference bakes it into
        its program (``mxnet_tpu/module/module.py:618-653``): a sentinel
        toggle or another action between fits rebuilds the step (its
        graphs dropped, the optimizer state kept); the same action under
        a fresh monitor reuses the step and its graphs, which fold into
        the device's health buffers (``health.HealthMonitor.
        device_state``).

        Under an lr scheduler the two forms differ at a schedule
        boundary: the fused step moves every update count first and then
        reads ``host_lr()``, while the loop reads each parameter's lr
        before its count moves, so the first parameter of the boundary
        step takes the old lr (the reference documents the same,
        ``mxnet_tpu/module/module.py:608-611``).  So "captured equals the
        loop bit for bit" holds only without a scheduler."""
        metric = self._device_metric(eval_metric)
        self._sync_health_key()
        if self._fused is not None and not self._adopt_metric(metric):
            self._fused = None          # rebuilt below, state kept
        elif self._fused is not None and \
                self._functional_opt.mult_signature != \
                self._optimizer._mult_signature():
            self._fused = None          # lr/wd multipliers changed
        if self._fused is None and not self._fused_unavailable:
            self._try_build_fused(metric)
        if self._fused is None:
            super()._fit_step(data_batch)
            return False
        self._health_ref = _health.active_monitor()
        self._run_fused(data_batch)
        return metric is not None

    def _sync_health_key(self):
        """Drop a fused step whose folded probe is not the active
        monitor's (rebuilt by the caller with the state kept)."""
        if self._fused is not None and \
                _health.fold_key() != self._fused_health_key:
            self._fused = None

    def _adopt_metric(self, metric):
        """Whether the fused step serves ``metric``: it is the step's own,
        or a fresh one of the same device form (``device_fold_key``; each
        ``fit`` makes a new metric from a string), which then takes over
        the step's accumulators, the tensors its graphs add into (the
        old metric's pending sums are drained into it first)."""
        old = self._fused_metric
        if metric is old:
            return True
        if metric is None or old is None or \
                metric.device_fold_key() != old.device_fold_key():
            return False
        old._drain_device()
        metric._take_accumulators(old)
        self._fused_metric = self._fused.metric = metric
        return True

    def _warm_start(self, eval_metric=None, data_sig=None):
        """Build the fused step before the first batch and capture its
        signatures (``mxnet_tpu/module/module.py:956-1090``): the fuse
        passes, shape inference, the graph function and, on the card, the
        kernel libraries the graph launches (``nvcc`` at first use); then
        the warm-up and capture of each signature, on this thread: the
        bound one and every ``fit_step`` entry of the warmup manifest
        with this symbol's fingerprint and this step's meta (a signature
        another process met, a last short batch).  A warm-up is a real
        step on the module's parameters, metric and health buffers,
        undone after, so it runs here, where every other reader of them
        runs (the reference compiles on a pool; its compile reads no
        state).  A signature other than the bound one gets batch buffers
        of its own shapes.  With ``MXTPU_COMPILE_CACHE`` the captures
        count ``compile.warmup_traces`` (``compile_cache.warmup``); what
        a warm-up raises is raised here.  ``data_sig`` is the iterator's
        signature (``compile_cache.warm_start``)."""
        from .. import metric as _metric
        if not (self.binded and self.params_initialized and
                self.optimizer_initialized):
            return
        metric = None
        if eval_metric is not None:
            metric = self._device_metric(_metric.create(eval_metric))
        self._sync_health_key()
        if self._fused is not None and not self._adopt_metric(metric):
            self._fused = None
        if self._fused is None and not self._fused_unavailable:
            self._try_build_fused(metric)
        if self._fused is None:
            return
        self._health_ref = _health.active_monitor()
        if self._context[0].device_type == 'gpu':
            from ..ops import _kernels
            for name in self._fused.kernels:
                _kernels.library(name)
        batch = self._fused_buffers()[3]
        bound = compile_cache.batch_sig(batch)
        if data_sig is not None and data_sig != bound:
            self.logger.info('warm start: the iterator\'s signature is not '
                             'the bound one; its first batch captures')
        sigs = {bound: None}
        meta = self._fit_meta()
        for entry in compile_cache.manifest_entries(
                'fit_step', compile_cache.fingerprint(self._symbol)):
            if entry.get('meta') != meta or not entry.get('batch'):
                continue
            shapes = {name: (tuple(sd[0]), str(sd[1]))
                      for name, sd in entry['batch'].items()}
            if set(shapes) == set(batch):
                sigs.setdefault(compile_cache.sig_key(shapes), shapes)
        self._warm_sigs = list(sigs)
        for sig, shapes in sigs.items():
            if compile_cache.cache_dir() is None:
                self._warm_sig(sig, shapes)
            else:
                compile_cache.warmup(
                    'fit_step', functools.partial(self._warm_sig, sig, shapes))

    def _warm_sig(self, sig, shapes):
        """Warm up and capture ``sig``'s step (unless held already) over
        its batch buffers: the bound ones, or buffers of ``shapes`` made
        as the first batch of that signature would make them."""
        params, frozen, aux, batch = self._fused_buffers()
        if compile_cache.batch_sig(batch) != sig:
            device = self._context[0].torch_device
            batch = self._sig_batches.get(sig) or {
                name: torch.zeros(shape, dtype=getattr(torch, dt),
                                  device=device)
                for name, (shape, dt) in shapes.items()}
        cap = self._graphs.get(sig)
        if cap is None or not cap.holds(self._step_tensors(params, frozen,
                                                           aux, batch)):
            cap = self._make_step(sig, params, frozen, aux, batch)
        if cap.skip is None and not cap.captured:
            self._warm_step(cap, batch)

    def _fit_meta(self):
        """The ``meta`` of this step's manifest entries, in the
        reference's form (``mxnet_tpu/parallel/train_step.py:219-227``):
        the metric's fold key (the port's module names written as the
        reference's), the compute dtype, the health action, no mesh."""
        metric = self._fused_metric
        key = compile_cache.reference_names(metric.device_fold_key()) \
            if metric is not None else None
        dtype = compile_cache._dtype_name(self._compute_dtype) \
            if self._compute_dtype is not None else None
        return compile_cache.jsonable({'metric': key, 'compute_dtype': dtype,
                                       'health': self._fused_health_key,
                                       'mesh': None})

    def _record_fit_step(self, batch):
        """File ``batch``'s signature in the warmup manifest as a
        ``'fit_step'`` entry (a no-op without ``MXTPU_COMPILE_CACHE``)."""
        if compile_cache.ensure_persistent_cache() is None:
            return
        compile_cache.record_entry({
            'kind': 'fit_step', 'fp': compile_cache.fingerprint(self._symbol),
            'meta': self._fit_meta(),
            'batch': {name: [list(v.shape), compile_cache._dtype_name(
                v.dtype)] for name, v in batch.items()}})

    def _warm_step(self, cap, batch=None):
        """Run ``cap``'s step once, undo it, and capture it: parameters,
        aux, optimizer state, the metric's accumulators, the health state
        and the device generator are written back as they were (the
        update counts are the host's and never move).  ``batch``: the
        step's batch buffers (the bound ones by default)."""
        params, frozen, aux, bound = self._fused_buffers()
        batch = bound if batch is None else batch
        device = next(iter(batch.values())).device
        tensors = compile_cache.step_tensors(params, aux,
                                             self._fused_opt_state,
                                             self._health_state(device))
        if self._fused_metric is not None:
            tensors += self._fused_metric._accumulators(device)
            if self._fused_health_key == 'skip_update':
                tensors += compile_cache.step_tensors(
                    self._fused_metric._held(device))
        gens = [_random.generator(device)] if compile_cache.random_nodes(
            self._fused.program) else []
        restore = compile_cache.snapshot(tensors, gens)
        self._first_step(cap, compile_cache.batch_sig(batch), batch)
        restore()

    def _first_step(self, cap, sig, batch):
        """The first step of a signature: the eager warm-up and, on the
        card, the capture; its signature goes into the warmup manifest.
        With the performance plane on, the step's FLOPs are counted over
        the warm-up (never inside the capture), or read from the
        manifest's ``step_cost`` row a previous process filed, and its
        graph pool's reserved bytes become one ledger entry."""
        if not getattr(cap, 'recorded', False):
            self._record_fit_step(batch)
            cap.recorded = True
        if not _perfwatch.capture_on():
            outs = self._warm_up(cap)
            if cap.skip is None:
                cap.capture()
            return outs
        key = self._perf_key(sig)
        known = _perfwatch.manifest_flops('fit_step', key)
        if known is None:
            with _perfwatch.count_flops() as fc:
                outs = self._warm_up(cap)
            cost = {'flops': fc.flops, 'aten_flops': fc.aten_flops,
                    'kernel_flops': fc.kernel_flops}
        else:
            outs = self._warm_up(cap)
            cost = {'flops': known}
        if cap.skip is None:
            cap.capture(measure=True)
        pool = cap.pool_bytes or 0
        cost['pool_bytes'] = pool
        cap.cost = _perfwatch.register_executable(
            'fit_step', key, cost, file=known is None) or cost
        if pool > 0:
            _perfwatch.ledger_alloc('graph_pool', cap, nbytes=pool)
        return outs

    def _warm_up(self, cap):
        """``cap``'s eager warm-up; the metric's host count of its batch
        is kept with it (a replay runs no host code, and another
        signature's step may have run the body since)."""
        outs = cap.warm_up()
        cap.metric_count = self._fused.metric_count
        return outs

    def _perf_key(self, sig):
        return (compile_cache.fingerprint(self._symbol), sig)

    def _health_state(self, device):
        """The health buffers the fused step folds into on ``device``
        (None without a folded probe)."""
        if self._fused_health_key is None or self._health_ref is None:
            return None
        return self._health_ref.device_state(device)

    def _try_build_fused(self, metric=None):
        """(``mxnet_tpu/module/module.py:662-731``)"""
        from ..parallel.train_step import make_fit_step
        self._fused_unavailable = True        # until proven otherwise
        if not _config.get('MXTPU_FUSED_FIT'):
            return
        if not (self.binded and self.params_initialized and
                self.optimizer_initialized):
            return
        if self._exec_group.execs[0]._monitor_callback is not None:
            return
        if self.inputs_need_grad or \
                self._exec_group.grad_req_spec != 'write':
            return
        exec_ = self._exec_group.execs[0]
        trainable = [n for n in self._param_names if n in exec_.grad_dict]
        frozen = [n for n in self._param_names
                  if n not in exec_.grad_dict and n in exec_.arg_dict]
        indices = {n: i for i, n in enumerate(self._param_names)}
        functional = self._optimizer.make_functional(trainable, indices)
        if functional is None:
            return
        self._functional_opt = functional
        self._fused_trainable = trainable
        self._fused_frozen = frozen
        hkey = _health.fold_key()
        self._fused = make_fit_step(
            self._symbol, functional, data_names=self._data_names,
            compute_dtype=self._compute_dtype, metric=metric,
            metric_label=self._label_names[0] if metric else None,
            health_action=hkey)
        self._fused_metric = metric
        self._fused_health_key = hkey
        if self._fused_opt_state is None:
            self._fused_opt_state = functional.init(
                {n: exec_.arg_dict[n].handle for n in trainable})
            # a loaded .states file, or the loop path's state
            self._overlay_updater_states()
        self._lr_t = torch.zeros((), dtype=torch.float32,
                                 device=self._context[0].torch_device)
        self._drop_graphs()
        self._fused_unavailable = False

    def _fused_buffers(self):
        """The fixed buffers of the fused step: (params, frozen, aux,
        batch) name -> tensor dicts of the bound arrays."""
        group = self._exec_group
        exec_ = group.execs[0]
        return ({n: exec_.arg_dict[n].handle for n in self._fused_trainable},
                {n: exec_.arg_dict[n].handle for n in self._fused_frozen},
                {k: v.handle for k, v in exec_.aux_dict.items()},
                {n: exec_.arg_dict[n].handle
                 for n in group.data_names + group.label_names})

    def _family_pool(self):
        """The graph memory pool this module's graphs share with its
        bucket family."""
        owner = self._pool_owner or self
        if owner._graph_pool is None:
            owner._graph_pool = torch.cuda.graph_pool_handle()
        return owner._graph_pool

    def _step_tensors(self, params, frozen, aux, batch):
        health = self._health_state(next(iter(batch.values())).device)
        return compile_cache.step_tensors(params, frozen, aux, batch,
                                          self._fused_opt_state,
                                          self._lr_t, health)

    def _step_graph(self, params, frozen, aux, batch):
        """The captured step of ``batch``'s signature over these buffers,
        made on a miss (or when its tensors were rebound)."""
        sig = compile_cache.batch_sig(batch)
        cap = self._graphs.get(sig)
        if cap is None or not cap.holds(self._step_tensors(params, frozen,
                                                           aux, batch)):
            cap = self._make_step(sig, params, frozen, aux, batch)
        return cap

    def _make_step(self, sig, params, frozen, aux, batch):
        """A new captured step of ``sig`` over these buffers, kept with
        its batch buffers."""
        health = self._health_state(next(iter(batch.values())).device)
        pool = self._family_pool() if self._lr_t.is_cuda else None
        cap = self._graphs[sig] = self._fused.capture(
            params, frozen, aux, self._fused_opt_state, batch, self._lr_t,
            pool=pool, copy_outputs=True, health_state=health)
        self._sig_batches[sig] = batch
        return cap

    def _incoming_sig(self, data_batch):
        """The batch signature ``data_batch`` will have once loaded (None
        when its arrays do not match the bound inputs one to one)."""
        group = self._exec_group
        values = list(data_batch.data or [])
        values += list(data_batch.label or []) if group.label_shapes else []
        names = group.data_names + group.label_names
        if len(values) != len(names):
            return None
        tensors = [group._host(v) for v in values]
        return compile_cache.sig_key({
            n: (tuple(t.shape), compile_cache._dtype_name(t.dtype))
            for n, t in zip(names, tensors)})

    def _use_sig_batch(self, data_batch):
        """Before a batch is loaded: point the bound input arrays at its
        signature's own batch buffers (those its graph reads), so
        ``load_batch`` copies into them in place."""
        if len(self._sig_batches) < 2:
            return              # the bound buffers are the only ones
        sig = self._incoming_sig(data_batch)
        bufs = self._sig_batches.get(sig)
        if bufs is None:
            return
        arg_dict = self._exec_group.execs[0].arg_dict
        for name, buf in bufs.items():
            if arg_dict[name].handle is not buf:
                arg_dict[name]._set_data(buf)

    def _run_fused(self, data_batch):
        """(``mxnet_tpu/module/module.py:809``)"""
        group = self._exec_group
        exec_ = group.execs[0]
        self._use_sig_batch(data_batch)
        group.load_batch(data_batch)
        buffers = self._fused_buffers()
        sig = compile_cache.batch_sig(buffers[3])
        cap = self._step_graph(*buffers)
        for idx, name in enumerate(self._param_names):
            if name in exec_.grad_dict:
                self._optimizer._update_count(idx)
        self._lr_t.fill_(self._optimizer.host_lr())
        if resilience.faults_on():
            # the straggler fault site: MXTPU_FAULTS='fit.step:delay:P:S'
            # slows this process's step cadence
            resilience.fault_point('fit.step')
        # perf.phase.dispatch times the steps that replay (or, eager,
        # rerun) a signature; perf.phase.capture its first
        first = not cap.captured and cap.cost is None
        try:
            with _perfwatch.phase('capture' if first else 'dispatch',
                                  cap.device):
                outs = self._first_step(cap, sig, buffers[3]) if first \
                    else cap.run()
        except Exception as exc:
            # an out-of-memory error becomes a postmortem
            _perfwatch.on_error(exc, 'fit_step', self._perf_key(sig))
            raise
        health = self._health_state(cap.device)
        if health is not None:
            self._health_ref.set_device_state(health)
        if self._fused_metric is not None:
            self._fused_metric._fold_count(cap.metric_count)
        instrument.inc('module.fused_steps')
        if _perfwatch.capture_on():
            if not cap.captured:
                for o in outs:
                    _perfwatch.ledger_alloc('fit.outputs', o)
            rows = data_batch.data[0].shape[0] if data_batch.data else 0
            _perfwatch.note_step('fit_step', self._perf_key(sig), rows,
                                 cap.device)
        exec_.outputs = [NDArray(o, exec_._ctx) for o in outs]
        self._params_dirty = True
