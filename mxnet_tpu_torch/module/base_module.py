"""BaseModule — the high-level train/predict interface; the port of
``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``).

``fit`` is the reference loop (``base_module.py:369-503``): bind ->
init_params -> init_optimizer -> per batch one training step (``Module``
fuses forward, backward and update, see ``Module._fit_step``) and the
metric update, epoch-end logging, ``epoch_end_callback``, evaluation.
``fit(warm_start=...)`` (default: the ``MXTPU_WARM_START`` knob) builds
the fused step, and on the card captures it, before the first batch
(``compile_cache.warm_start``); a ``BucketingModule`` under
``MXTPU_PRECOMPILE_BUCKETS`` with declared ``bucket_keys`` does so for
every declared bucket whatever it says.

The loop is the reference's sync-free one (``base_module.py:413-440``):
at most ``MXTPU_ASYNC_DEPTH`` steps in flight (``engine.StepWindow``,
each step's ticket a CUDA event recorded after it), and under
``MXTPU_DEVICE_FEED`` the batches come through an ``io.DeviceFeedIter``
that stages batch N+1 on the card while step N runs.  A captured step's
outputs are the graph's and the next replay overwrites them: the host
metric update, ``batch_end_callback`` and ``get_outputs`` read them
before the next step is launched, in stream order, and the window
drains before the epoch-end metric read.

``fit(checkpoint_prefix=...)`` writes ``prefix-symbol.json`` and
``prefix-%04d.params`` every ``checkpoint_period`` epochs (and after the
last), atomically, after the window has drained; with ``auto_resume``
(default: the ``MXTPU_AUTO_RESUME`` knob) it first restarts from the
newest loadable checkpoint above ``begin_epoch`` (``checkpoint.resumes``;
the parameters only: the update count and optimizer state start again,
as in the reference).  ``fit(monitor=...)`` installs the monitor after
bind (a monitored module trains through the per-parameter loop, eagerly)
and calls its ``tic``/``toc_print`` around every step, as the reference
does.

The observability planes ride the loop as in the reference
(``base_module.py:307-383``): ``fit`` activates a fresh health monitor
(``MXTPU_HEALTH_SENTINELS``; its probe rides the fused step, and a step
that takes the per-parameter loop with sentinels on warns once that the
probe is inactive), re-reads the performance plane (``MXTPU_PERFWATCH``,
``MXTPU_STEP_SAMPLE``), opens the goodput ledger (``MXTPU_IOWATCH``:
each step inside ``traced_dispatch``, checkpoints and evaluation in
their buckets, the ledger closed in a ``finally``), and starts the
chronicle (``MXTPU_CHRONICLE``).

With a store (``fit(kvstore=...)``, ``Module.init_optimizer``), a fit
that unwinds with an error leaves it first (``kv.leave()``: the process
stops heartbeating, so its peers' barriers exclude it), and a
``dist_async`` fit ends in the store's barrier, which holds every live
rank until all have flushed their pushes (rank 0 hosts the server).  The
elastic coordinator (``mxnet_tpu/module/base_module.py:285``,
``_elastic.activate_fit``) waits for ``elastic.py``.

``fit(mesh=, partition=)`` (defaults: the ``MXTPU_MESH`` /
``MXTPU_PARTITION`` knobs) installs a dp×tp plan before bind
(``_set_parallel``: ``Module`` and ``BucketingModule`` implement it; other
modules warn that they train on their own layout).  Over a mesh of more
than one rank every rank runs the same fit: ``auto_resume``'s newest
checkpoint is rank 0's, broadcast, and the epoch's checkpoint is written
by rank 0 while the others wait at a barrier.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

import torch

from .. import config as _config
from .. import chronicle as _chronicle
from .. import health as _health
from .. import instrument
from .. import io as _io
from .. import iowatch as _iowatch
from .. import metric as _metric
from .. import perfwatch as _perfwatch
from ..engine import StepWindow

__all__ = ['BaseModule', 'BatchEndParam']

BatchEndParam = namedtuple('BatchEndParams',
                           ['epoch', 'nbatch', 'eval_metric', 'locals'])


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _check_input_names(symbol, names, typename, throw):
    """(reference base_module.py:33)"""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if
                      not arg.endswith(('_weight', '_bias', '_gamma',
                                        '_beta'))]
        msg = "You created Module with Module(..., %s_names=%s) but " \
              "input with name '%s' is not found in symbol.list_arguments(). " \
              "Did you mean one of:\n\t%s" % (
                  typename, str(names), name, '\n\t'.join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule(object):
    """(reference base_module.py:64)"""

    def __init__(self, logger=logging):
        self.logger = logger
        self._window = None         # the running fit's StepWindow
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level API ----------------------------------------------------
    def forward_backward(self, data_batch):
        """(reference base_module.py:192)"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fit_step(self, data_batch, eval_metric=None):
        """One training step of the fit loop.  Returns truthy when the
        step also accumulated ``eval_metric`` (the caller then skips the
        host-side ``update_metric``); ``Module`` overrides it with the
        fused step."""
        mon = _health.active_monitor()
        if mon is not None:
            # the sentinels ride the fused step only: say so, once a fit
            mon.warn_unfused()
        self.forward_backward(data_batch)
        self.update()
        return False

    def _device_place_fn(self):
        """The device feed's placement function (``io.DeviceFeedIter``),
        or None when this module has no bound device placement —
        ``Module`` returns its executor group's ``_place_data``."""
        return None

    def _feed_device(self):
        """The ``torch.device`` the feed stages batches onto."""
        return None

    def _drain_window(self):
        """Wait out the steps the running fit has in flight (before a
        checkpoint reads the parameters or optimizer state they write)."""
        if self._window is not None:
            self._window.drain()

    def _set_parallel(self, mesh, partition=None):
        """Install a dp×tp plan (``fit(mesh=...)``).  ``Module`` and
        ``BucketingModule`` implement it; other module types train on
        their own layout and say so instead of ignoring the request
        silently (``mxnet_tpu/module/base_module.py:97-105``)."""
        self.logger.warning(
            '%s does not implement fit(mesh=...): the mesh/partition '
            'request is ignored and training stays on the module\'s '
            'own device layout', type(self).__name__)

    def _mesh_coordinator(self):
        """The mesh whose ranks share this fit's checkpoints, or None."""
        plan = getattr(self, '_mesh_plan', None)
        return plan.mesh if plan is not None and plan.multi_rank else None

    def _metric_dp(self):
        """``(dp group, dp)`` when this fit's ranks split each batch over
        more than one dp position, else None."""
        coord = self._mesh_coordinator()
        if coord is None or self._mesh_plan.dp == 1:
            return None
        from ..parallel.mesh import DP_AXIS
        return coord.group(DP_AXIS), self._mesh_plan.dp

    def _ticket_outputs(self):
        """The outputs the step ticket waits on (``Module``: this rank's,
        with no collective)."""
        return self.get_outputs()

    def _step_ticket(self):
        """What ``engine.StepWindow`` waits on for the last launched
        step: a CUDA event recorded after it on the card, its output
        tensors on the CPU."""
        try:
            outs = [o.handle for o in self._ticket_outputs()]
        except (AssertionError, AttributeError, IndexError):
            return None
        if not outs:
            return None
        if outs[0].is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(outs[0].device))
            return event
        return outs

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on eval_data (reference base_module.py:205)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` per batch, the outputs cut
        to the batch's real rows (reference base_module.py:262)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """(reference base_module.py:286)"""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    'Cannot merge batches, as num of outputs is not the ' \
                    'same in mini-batches. Maybe bucketing is used?'
            from .. import ndarray as nd
            merged = [nd.concatenate([out[i] for out in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None, kvstore='local',
            optimizer='sgd', optimizer_params=(('learning_rate', 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_prefix=None, checkpoint_period=1,
            auto_resume=None, warm_start=None, mesh=None, partition=None):
        """Train (reference base_module.py:369-503).

        ``mesh`` (default: the MXTPU_MESH knob) trains over a dp×tp mesh
        of ranks, one process per position (``'4x2'``, ``'dp=4,tp=2'``,
        ``8``; ``parallel/mesh.py``): the batch split over dp, parameters
        per ``partition`` (default: the MXTPU_PARTITION knob;
        ``'replicated'``, ``'auto'`` or a name dict), optimizer state
        ZeRO-sharded over dp, BatchNorm over the global batch, a dist
        kvstore demoted to its control plane.  ``partition`` without a
        mesh is ignored, as in the reference."""
        assert num_epoch is not None, 'please specify number of epochs'
        if initializer is None:
            from .. import initializer as _init
            initializer = _init.Uniform(0.01)
        # the mesh knobs resolve, and the plan is installed, before bind
        # so the executor group binds this rank's rows
        if mesh is None:
            mesh = _config.get('MXTPU_MESH') or None
        if partition is None:
            partition = _config.get('MXTPU_PARTITION') or None
        if mesh is not None:
            self._set_parallel(mesh, partition)
        if checkpoint_prefix:
            if auto_resume is None:
                auto_resume = _config.get('MXTPU_AUTO_RESUME')
            if auto_resume:
                from ..model import find_latest_checkpoint, load_checkpoint
                latest = find_latest_checkpoint(checkpoint_prefix)
                coord = self._mesh_coordinator()
                if coord is not None:
                    # every rank resumes from rank 0's newest checkpoint
                    from ..parallel import collectives
                    box = [latest]
                    collectives._dist().broadcast_object_list(box, src=0)
                    latest = box[0]
                if latest is not None and latest > begin_epoch:
                    _, arg_params, aux_params = load_checkpoint(
                        checkpoint_prefix, latest)
                    begin_epoch = latest
                    force_init = True
                    instrument.inc('checkpoint.resumes')
                    self.logger.info('Auto-resuming from checkpoint '
                                     '"%s-%04d.params"', checkpoint_prefix,
                                     latest)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        # the planes (reference base_module.py:307-330): a fresh health
        # monitor, active before the warm start so the warmed step folds
        # the same probe; the performance plane's knobs; the chronicle;
        # the goodput ledger, opened on this thread (None when another
        # fit's ledger is live: this fit then neither owns nor closes it)
        _health.activate()
        try:
            _perfwatch.activate_fit()
            _chronicle.refresh()
            gp_token = _iowatch.activate_fit()
        except BaseException:
            _health.deactivate()
            raise
        # over more than one dp rank the metric's drains sum over dp while
        # this fit runs (every rank reaches them together); once it
        # returns or unwinds the metric is the caller's again, read with
        # no collective
        dp = self._metric_dp()
        if dp is not None:
            _metric.set_dp_group(eval_metric, *dp)
        try:
            try:
                try:
                    self._fit_planned(train_data, eval_data, eval_metric,
                                      validation_metric, epoch_end_callback,
                                      batch_end_callback, eval_end_callback,
                                      eval_batch_end_callback, begin_epoch,
                                      num_epoch, warm_start,
                                      checkpoint_prefix, checkpoint_period,
                                      monitor)
                except BaseException:
                    # an unwinding fit leaves the dist store first (stops
                    # heartbeating): a failed-but-alive process must read
                    # as dead to its peers, or their end-of-fit barrier
                    # waits MXTPU_KV_BARRIER_TIMEOUT for it
                    # (mxnet_tpu/module/base_module.py:366-375)
                    kv = getattr(self, '_kvstore', None)
                    if kv is not None and hasattr(kv, 'leave'):
                        try:
                            kv.leave()
                        except Exception:       # noqa: BLE001
                            pass
                    raise
            finally:
                # the skipped-step totals reach the ledger before the
                # monitor is torn down, from the fit that owns the ledger
                if gp_token is not None:
                    _iowatch.note_health(_health.active_monitor())
                _health.deactivate()
                _perfwatch.harvest()
            # the end-of-fit rendezvous, dist_async only
            # (mxnet_tpu/module/base_module.py:386-404): rank 0 hosts the
            # server in-process, so a fast rank must not exit and tear it
            # down under slower workers.  The barrier flushes this
            # worker's pushes and holds every LIVE rank (dead ones are
            # excluded by their heartbeats; the wait is bounded by
            # MXTPU_KV_BARRIER_TIMEOUT).  dist_sync has no server to
            # protect and its collective barrier excludes no dead rank,
            # so it takes none.  Inside the ledger window: the wait is
            # the 'barrier' bucket.
            kv = getattr(self, '_kvstore', None)
            kv_type = getattr(kv, 'type', '')
            if kv is not None and 'dist' in kv_type and 'async' in kv_type:
                kv.barrier()
        finally:
            if dp is not None:
                _metric.set_dp_group(eval_metric, None, 1)
            if gp_token is not None:
                _iowatch.goodput_end(gp_token)

    def _fit_planned(self, train_data, eval_data, eval_metric,
                     validation_metric, epoch_end_callback,
                     batch_end_callback, eval_end_callback,
                     eval_batch_end_callback, begin_epoch, num_epoch,
                     warm_start, checkpoint_prefix, checkpoint_period,
                     monitor):
        if warm_start is None:
            warm_start = _config.get('MXTPU_WARM_START')
        if warm_start or getattr(self, '_warm_eager', False):
            from .. import compile_cache
            with _iowatch.account('compile'):
                compile_cache.warm_start(self, eval_metric,
                                         data_iter=train_data)
        window = StepWindow(_config.get('MXTPU_ASYNC_DEPTH'))
        feed = None
        if _config.get('MXTPU_DEVICE_FEED') and \
                not isinstance(train_data, _io.DeviceFeedIter):
            place = self._device_place_fn()
            if place is not None:
                train_data = feed = _io.DeviceFeedIter(
                    train_data, place, device=self._feed_device())
        self._window = window
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch,
                             num_epoch, window, checkpoint_prefix,
                             checkpoint_period, monitor)
        finally:
            self._window = None
            # hand the caller's iterator back in a clean state (the feed
            # runs one fetch ahead of the consumer)
            if feed is not None:
                feed.close()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    window, checkpoint_prefix=None, checkpoint_period=1,
                    monitor=None):
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                # MXTPU_STEP_SAMPLE: every Nth step fully syncs after its
                # launch for an honest step latency (perf.step_latency)
                sampled = _perfwatch.sample_tick()
                if sampled:
                    samp_t0 = time.perf_counter()
                    samp_ts = time.time_ns() // 1000
                # a step that captured a graph spent its time compiling:
                # the goodput ledger charges it to 'compile'
                with _iowatch.traced_dispatch():
                    metric_on_device = self._fit_step(data_batch,
                                                      eval_metric)
                window.admit(self._step_ticket())
                if sampled:
                    with _iowatch.account('metric_drain'):
                        _perfwatch.sample_sync(self._step_ticket(),
                                               samp_t0, samp_ts)
                instrument.inc('fit.batches')
                if not metric_on_device:
                    self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
            # the epoch boundary is a real barrier
            window.drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info('Epoch[%d] Train-%s=%f', epoch, name, val)
            self.logger.info('Epoch[%d] Time cost=%.3f', epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            if checkpoint_prefix and ((epoch + 1) % checkpoint_period == 0
                                      or epoch + 1 == num_epoch):
                from ..model import save_checkpoint
                coord = self._mesh_coordinator()
                with _iowatch.account('checkpoint'):
                    if coord is None or coord.rank == 0:
                        save_checkpoint(checkpoint_prefix, epoch + 1,
                                        self.symbol, arg_params_,
                                        aux_params_)
                    if coord is not None:
                        coord.barrier()
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                with _iowatch.account('eval'):
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                for name, val in res:
                    self.logger.info('Epoch[%d] Validation-%s=%f', epoch,
                                     name, val)
            train_data.reset()

    # -- symbol ------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    # -- abstract interface ------------------------------------------------
    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save the parameters as ``arg:``/``aux:`` entries, committed
        atomically (reference base_module.py:590)."""
        from .. import ndarray as nd
        from .. import resilience
        arg_params, aux_params = self.get_params()
        coord = self._mesh_coordinator()
        if coord is not None and coord.rank != 0:
            return          # a mesh's rank 0 writes
        save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
        save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
        with resilience.atomic_replace(fname) as tmp:
            nd.save(tmp, save_dict)

    def load_params(self, fname):
        """(reference base_module.py:601)"""
        from .. import ndarray as nd
        arg_params, aux_params = {}, {}
        for k, value in nd.load(fname).items():
            arg_type, name = k.split(':', 1)
            if arg_type == 'arg':
                arg_params[name] = value
            elif arg_type == 'aux':
                aux_params[name] = value
            else:
                raise ValueError('Invalid param file ' + fname)
        self.set_params(arg_params, aux_params)

    def get_states(self, merge_multi_context=True):
        """A module without states has none (reference
        base_module.py:617)."""
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        raise NotImplementedError()

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()
