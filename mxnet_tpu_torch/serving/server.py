"""Multi-model serving fleet — the port of ``mxnet_tpu/serving/server.py``.

:class:`ModelServer` holds named models, each served by N **replicas**
behind ONE shared admission queue with per-replica
:class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher` workers.

- **A replica** is a :class:`~mxnet_tpu_torch.predictor.Predictor` of its
  own (its own parameter copy, pow2 bucket executors, CUDA graphs and
  graph memory pool: graphs of one pool must never replay at once, so no
  pool is shared across replicas) behind a lock, plus a CUDA stream of
  its own (a ``torch.cuda.Stream``): the worker's staging copy, graph
  replay and copy-out all run on it, so replicas on one card overlap
  instead of queueing on the default stream.  The copy-out waits on
  that stream only.  Replica slot ``s`` runs on device
  ``(dev_id + s) % torch.cuda.device_count()``: on one card every
  replica shares it.  A server built with
  ``dev_type='cpu'`` runs every replica on the host, with no stream; a
  GPU server raises at ``load_model`` when there is no card.
- **Warm before serve.** Every replica the server builds is warmed
  before its worker attaches: ``Predictor.warm_buckets`` builds, and on
  the card captures, every pow2 bucket up to the batcher's cap; a
  prebuilt predictor without ``warm_buckets`` forwards zeros through
  each bucket.  A failure raises at ``load_model``/``scale_up``/
  ``reload_model`` (the reference swallows it because its hot path
  compiles lazily, ``mxnet_tpu/serving/server.py:405-412``; a replica
  here never falls back to eager execution).  ``load_model``'s
  ``warm_start`` defaults to True here (the reference's None reads
  ``MXTPU_WARM_START``), and a GPU server refuses ``warm_start=False``
  and ``scale_up(warm=False)``: an unwarmed bucket would record its
  graph on the request path.
- **Replica fleet**: :meth:`scale_up` / :meth:`scale_down` grow and
  shrink the replica set while traffic flows; a new replica captures
  while the others replay (captures run in ``thread_local`` error mode,
  one at a time process-wide, on a stream of their own:
  ``compile_cache.capture_stream``).
  Scaling, load/unload/reload and the supervisor's repairs serialize on
  the per-model admin lock.
- **Hot reload**: every replacement Predictor is built and warmed BEFORE
  the first swap; each replica swaps under its own lock between
  flushes.  The old Predictors, their graphs and their pools are freed
  after the swap (``compile_cache.release_memory`` on a GPU server), so
  reserved memory stays flat across reloads.
- **Admission + SLO**: the per-lane queue bound sheds with
  :class:`ServerOverloadedError`; deadlines drop requests typed
  (:class:`DeadlineExceededError`); latencies land in ``serving.*_secs``
  histograms, model-wide and labeled per replica and lane.
- **Autoscaling**: :meth:`autoscale` enrolls a model with the
  :class:`~mxnet_tpu_torch.serving.autoscaler.ReplicaAutoscaler`, which
  holds its windowed p99 at an SLO (scale up/down, shrink/restore the
  max batch, brownout).  Every replica warms to the batcher's
  CONFIGURED cap, so one built while the autoscaler has the batch
  shrunk still captures every bucket a restore brings back.
- **Supervision**: :meth:`supervise` enrolls a model with the
  :class:`~mxnet_tpu_torch.serving.supervisor.FleetSupervisor`.
- **Attribution**: with servewatch on, :meth:`drain` commits its
  snapshot, the servewatch rings included, through the flight recorder.
- **Tensor-parallel replicas**: ``load_model(..., mesh='1x2',
  partition='auto')`` serves each replica from a sharded Predictor
  (``Predictor(mesh=, partition=, devices=)``) over a DISJOINT device
  set carved from the server's local devices (the CUDA devices; ``[cpu(0)]``
  for a CPU server): replica slot ``r`` of a dp×tp model owns devices
  ``[r·dp·tp, (r+1)·dp·tp)`` (``parallel.mesh.carve_submesh_devices``),
  and a slot past them raises the carve's error.  The replica capacity
  of a sharded model is ``max(1, submesh_capacity(mesh))``, so
  ``scale_up`` past it is refused (None) and the autoscaler takes its
  at-capacity relief instead; a partial ``reload_model`` keeps the stored
  ``mesh``/``partition``.  A prebuilt sharded Predictor (say over
  ``[gpu(0)] * 2``) serves through ``load_model(predictor=...)``.  Each
  sharded replica has its own stream and graph pool, as any replica.
"""
from __future__ import annotations

import contextlib
import logging
import re
import threading
import time

import numpy as np
import torch

from .. import compile_cache, config, health, instrument, resilience
from .. import model as model_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context
from ..predictor import Predictor
from . import servewatch
from .batcher import (DeadlineExceededError, DynamicBatcher,
                      ReplicaQuarantinedError, ServerOverloadedError)

__all__ = ['ModelServer', 'ModelNotFoundError', 'ServerOverloadedError',
           'DeadlineExceededError', 'ReplicaQuarantinedError']

_log = logging.getLogger('mxnet_tpu_torch.serving')

class ModelNotFoundError(MXNetError):
    """No model with that name is loaded."""


class _Replica(object):
    """One serving replica: a live Predictor behind a lock (flush against
    reload swap), the slot it was built for, and its CUDA stream (None on
    the host)."""
    __slots__ = ('rid', 'predictor', 'lock', 'stream')

    def __init__(self, rid, predictor, stream=None):
        self.rid = rid
        self.predictor = predictor
        self.lock = threading.Lock()
        self.stream = stream


class _Model(object):
    """One registry entry: the replica set, the shared batcher, the
    builder kwargs replicas are rebuilt from, and the ADMIN lock every
    lifecycle change (load/unload/reload/scale/repair) takes."""
    __slots__ = ('name', 'replicas', 'batcher', 'generation',
                 'admin_lock', 'build_kw', 'closed')

    def __init__(self, name):
        self.name = name
        self.replicas = []
        self.batcher = None
        self.generation = 0
        self.admin_lock = threading.RLock()
        self.build_kw = None
        self.closed = False

    @property
    def predictor(self):
        """The first replica's Predictor (the single-replica view)."""
        return self.replicas[0].predictor if self.replicas else None


class ModelServer(object):
    """Dynamic-batching model server over named Predictors.

    ``predict`` blocks on the response future; ``submit`` returns it.
    Per-request outputs are numpy arrays sliced to the request's rows.
    ``dev_type`` defaults to ``'gpu'`` (the reference's to ``'cpu'``): the
    port serves on the card unless asked for the host.
    """

    def __init__(self, max_delay_ms=None, max_batch=None, max_queue=None,
                 dev_type='gpu', dev_id=0):
        self._max_delay_ms = max_delay_ms
        self._max_batch = max_batch
        self._max_queue = max_queue
        self._dev = (dev_type, dev_id)
        self._models = {}
        self._lock = threading.Lock()
        self._closed = False
        self._autoscaler = None
        self._supervisor = None

    # -- replica devices ----------------------------------------------------

    def _capacity_for(self, entry):
        """Replica capacity from an entry in hand (the autoscaler passes
        the one it holds, so no registry lookup races an unload): a
        sharded model needs DISJOINT device sets, ``max(1,
        submesh_capacity(mesh))``; an unsharded one has no ceiling
        (replicas past the device count share devices round-robin)."""
        mesh = (entry.build_kw or {}).get('mesh')
        if mesh is None:
            return 1 << 30
        from ..parallel.mesh import submesh_capacity
        return max(1, submesh_capacity(mesh, self._local_devices()))

    def replica_capacity(self, name):
        """How many replicas the local devices can hold for ``name`` (the
        autoscaler's hard ceiling).  Sharded models need disjoint
        submeshes (``mesh.submesh_capacity``); unsharded ones are
        unbounded here, and the autoscaler's ``max_replicas`` governs."""
        return self._capacity_for(self._entry(name))

    def _local_devices(self):
        """The devices replicas are carved from: the CUDA devices for a GPU
        server, ``[cpu(0)]`` for a CPU one."""
        from ..parallel.mesh import local_devices
        return local_devices() if self._dev[0] == 'gpu' else \
            [Context('cpu', 0)]

    def _replica_devices(self, mesh, slot):
        """The device set of a sharded model's replica slot ``slot``: a
        disjoint submesh (``mesh.carve_submesh_devices``); the carve's
        error as an :class:`MXNetError` when no such set is left."""
        from ..parallel.mesh import carve_submesh_devices
        try:
            return carve_submesh_devices(mesh, slot, self._local_devices())
        except ValueError as e:
            raise MXNetError(str(e))

    def _replica_context(self, slot):
        """The Context of replica slot ``slot``: the server's device for
        slot 0, later slots walking the device list from there."""
        dev_type, dev_id = self._dev
        if dev_type != 'gpu':
            return Context(dev_type, 0)
        n = max(1, torch.cuda.device_count())
        return Context('gpu', (int(dev_id) + int(slot)) % n)

    def _replica_stream(self, slot, predictor):
        """A new CUDA stream on the replica's device: its Predictor's (a
        sharded one's first position), else slot ``slot``'s; None on the
        host."""
        ctx = getattr(predictor, '_ctx', None)
        if not isinstance(ctx, Context):
            ctx = self._replica_context(slot)
        if ctx.device_type != 'gpu':
            return None
        return torch.cuda.Stream(ctx.torch_device)

    def _refuse_cold(self, warm):
        if not warm and self._dev[0] == 'gpu':
            raise MXNetError('a GPU server warms (captures) every replica '
                             'before it serves; an unwarmed bucket would '
                             'record its graph on the request path')

    # -- registry -----------------------------------------------------------

    def _build_predictor(self, prefix=None, epoch=None, symbol_json=None,
                         params=None, input_shapes=None, output_keys=None,
                         mesh=None, partition=None, slot=0):
        if input_shapes is None:
            raise MXNetError('input_shapes is required')
        if prefix is not None:
            if epoch is None:
                epoch = model_mod.find_latest_checkpoint(prefix)
                if epoch is None:
                    raise MXNetError('no loadable checkpoint at %r'
                                     % prefix)
            with open('%s-symbol.json' % prefix) as f:
                symbol_json = f.read()
            params = nd.load('%s-%04d.params' % (prefix, epoch))
        if symbol_json is None or params is None:
            raise MXNetError('need prefix= or symbol_json= + params=')
        if mesh is not None:
            # each position holds its own copy of its shard
            return Predictor(symbol_json, params, dict(input_shapes),
                             dev_type=self._dev[0], dev_id=self._dev[1],
                             output_keys=output_keys, pad_to_bucket=True,
                             mesh=mesh, partition=partition,
                             devices=self._replica_devices(mesh, slot))
        ctx = self._replica_context(slot)
        if isinstance(params, dict):
            # each replica owns its parameters: an NDArray already on the
            # replica's device would otherwise be shared with the caller
            params = {k: (v.copy() if isinstance(v, nd.NDArray) and
                          v.context == ctx else v)
                      for k, v in params.items()}
        return Predictor(symbol_json, params, dict(input_shapes),
                         dev_type=ctx.device_type, dev_id=ctx.device_id,
                         output_keys=output_keys, pad_to_bucket=True)

    def load_model(self, name, prefix=None, epoch=None, symbol_json=None,
                   params=None, input_shapes=None, output_keys=None,
                   predictor=None, warm_start=True, replicas=None,
                   mesh=None, partition=None):
        """Register ``name`` and start its batcher; returns the first
        replica's Predictor.  The source is a checkpoint ``prefix`` (with
        ``epoch``; the latest loadable one otherwise), ``symbol_json`` +
        ``params`` (a dict, e.g. from ``convert.params_from_numpy``, or
        ``.params`` bytes), or a prebuilt ``predictor`` (a LIST of them
        for a prebuilt fleet).  ``replicas`` (default
        ``MXTPU_SERVE_REPLICAS``) replicas start, each warmed (captured on
        the card) before it serves.  ``mesh``/``partition`` serve each
        replica tensor-parallel over its own carved device set
        (``Predictor(mesh=...)``)."""
        if not re.fullmatch(r'[A-Za-z0-9._:-]+', str(name)):
            # the name becomes a metric label: label metacharacters
            # (| , = ") would forge labels downstream
            raise MXNetError(
                'model name %r must match [A-Za-z0-9._:-]+ (it becomes '
                'a metric label)' % (name,))
        reserved = {'name', 'priority', 'timeout', 'deadline_ms',
                    'self'} & set(input_shapes or {})
        if reserved:
            # submit()/predict() take these keyword names themselves
            raise MXNetError(
                'input name(s) %s collide with submit()/predict() '
                'keywords; rename the model inputs'
                % sorted(reserved))
        if self._dev[0] == 'gpu':
            Context(*self._dev).torch_device     # raises with no card
        self._refuse_cold(warm_start)
        if replicas is None:
            replicas = int(config.get('MXTPU_SERVE_REPLICAS'))
        replicas = max(1, int(replicas))
        build_kw = dict(prefix=prefix, epoch=epoch,
                        symbol_json=symbol_json, params=params,
                        input_shapes=input_shapes,
                        output_keys=output_keys, mesh=mesh,
                        partition=partition)
        prebuilt = None
        if predictor is not None:
            prebuilt = list(predictor) if isinstance(
                predictor, (list, tuple)) else [predictor]
            if len(prebuilt) > replicas:
                raise MXNetError(
                    'more prebuilt predictors (%d) than replicas (%d)'
                    % (len(prebuilt), replicas))
            if len(prebuilt) < replicas and symbol_json is None and \
                    prefix is None:
                raise MXNetError(
                    'prebuilt predictor count (%d) < replicas (%d) '
                    'and no builder source given'
                    % (len(prebuilt), replicas))
        with self._lock:
            if self._closed:
                raise MXNetError('server is closed')
            if name in self._models:
                raise MXNetError('model %r already loaded (use '
                                 'reload_model)' % name)
        # build the WHOLE fleet before publishing the entry: a predict
        # racing a slow load sees ModelNotFoundError, never half a model
        entry = _Model(name)
        entry.build_kw = build_kw
        try:
            with entry.admin_lock:
                first = prebuilt[0] if prebuilt else \
                    self._build_predictor(slot=0, **build_kw)
                rep0 = _Replica(0, first, self._replica_stream(0, first))
                if warm_start:
                    self._warm_predictor(self._warm_rows(), first)
                self._ready(rep0)
                entry.replicas.append(rep0)
                entry.batcher = DynamicBatcher(
                    name, self._make_execute(rep0),
                    max_delay_ms=self._max_delay_ms,
                    max_batch=self._max_batch,
                    max_queue=self._max_queue,
                    batch_inputs=first._batch_inputs)
                for slot in range(1, replicas):
                    pre = prebuilt[slot] if prebuilt and \
                        slot < len(prebuilt) else None
                    self._add_replica(entry, slot, predictor=pre,
                                      warm=warm_start)
        except Exception:
            if entry.batcher is not None:
                entry.batcher.stop(drain=False)
            raise
        with self._lock:
            if self._closed or name in self._models:
                entry.batcher.stop(drain=False)
                raise MXNetError('server is closed' if self._closed else
                                 'model %r already loaded (use '
                                 'reload_model)' % name)
            self._models[name] = entry
        self._note_models()
        self._note_replicas(entry)
        if config.get('MXTPU_SERVE_SUPERVISE'):
            self.supervise(name)
        return entry.predictor

    def _note_models(self):
        with self._lock:
            instrument.set_gauge('serving.models', len(self._models))

    def _note_replicas(self, entry):
        instrument.set_gauge('serving.replicas|model=%s' % entry.name,
                             len(entry.replicas))

    @staticmethod
    def _make_execute(rep):
        site_op = 'r%s' % rep.rid

        def _execute(inputs, rows):
            """Batcher hook: the merged batch through THIS replica's
            current Predictor, on the replica's stream.  The replica lock
            orders the flush against a reload's swap: the Predictor read
            here serves the whole batch.  ``last_info`` names the bucket
            the batch rode and a signature for it (servewatch's flush
            record)."""
            with rep.lock:
                if resilience.faults_on():
                    # 'serve.execute.r<id>', inside the lock, so an
                    # injected wedge holds the replica as a hung forward
                    # would
                    resilience.fault_point('serve.execute', op=site_op)
                predictor = rep.predictor
                with _on_stream(rep.stream):
                    predictor.forward(**inputs)
                    outs = [predictor.get_output(i)
                            for i in range(predictor.num_outputs)]
                bucket = getattr(predictor, '_active_bucket', None)
            if bucket is not None:
                _execute.last_info = (
                    bucket, '%s[b=%d]' % (type(predictor).__name__,
                                          bucket))
            return outs
        _execute.last_info = None
        return _execute

    def _warm_rows(self, entry=None):
        """The rows every replica warms to: the batcher's CONFIGURED cap
        (the server's max_batch before the batcher exists), not the live
        one, which the autoscaler may have shrunk: a replica built then
        must still hold every bucket a restore brings back."""
        if entry is not None and entry.batcher is not None:
            return entry.batcher.configured_max_batch
        return int(config.get('MXTPU_SERVE_MAX_BATCH')
                   if self._max_batch is None else self._max_batch)

    def _pow2_buckets(self, max_batch):
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b <<= 1
        buckets.append(compile_cache.pad_to_bucket(max_batch))
        return buckets

    def _warm_predictor(self, max_batch, predictor):
        """Build, and on the card capture, every pow2 bucket of
        ``predictor`` up to ``max_batch`` before it serves; a predictor
        without ``warm_buckets`` forwards zeros through each bucket.  A
        failure raises.  With ``MXTPU_COMPILE_CACHE`` the cubin store is
        installed first, so a served graph's Rtc kernels load from it."""
        from .. import compile_cache
        compile_cache.ensure_persistent_cache()
        warm = getattr(predictor, 'warm_buckets', None)
        if warm is not None:
            warm(max_batch)
            return
        shapes = getattr(predictor, '_input_shapes', None)
        batch_inputs = getattr(predictor, '_batch_inputs', None)
        if not shapes or not batch_inputs:
            return
        for bucket in self._pow2_buckets(max_batch):
            predictor.forward(**{
                k: np.zeros((bucket,) + tuple(s[1:]), np.float32)
                for k, s in shapes.items() if k in batch_inputs})

    def _ready(self, rep):
        """Order the replica's stream after the work the admin thread
        queued for it (parameter copies, the warm-up): the first replay
        must not start before them."""
        if rep.stream is not None:
            rep.stream.wait_stream(torch.cuda.current_stream(
                rep.stream.device))

    def _release_device_memory(self):
        """Return the memory of dropped Predictors (their graphs' pools
        included) to the card: a reload must not grow reserved memory."""
        if self._dev[0] == 'gpu':
            compile_cache.release_memory()

    def _add_replica(self, entry, slot, predictor=None, warm=True):
        """Build, warm and attach one replica (caller holds the admin
        lock); the worker attaches LAST, so its first flush replays."""
        if predictor is None:
            predictor = self._build_predictor(slot=slot,
                                              **entry.build_kw)
        rep = _Replica(slot, predictor,
                       self._replica_stream(slot, predictor))
        if warm:
            self._warm_predictor(self._warm_rows(entry), predictor)
        self._ready(rep)
        entry.replicas.append(rep)
        entry.batcher.add_worker(rep.rid, self._make_execute(rep))
        return rep

    # -- fleet scaling ------------------------------------------------------

    def scale_up(self, name, warm=True):
        """Add one replica on the lowest free slot; returns the new
        replica count, None when the model is unloaded or closing or, for
        a sharded model, no disjoint device set is left (the capacity
        refusals).  A genuine build failure (a missing checkpoint, a
        builder source dropped by a prebuilt reload, a failed capture)
        raises, and so does ``warm=False`` on a GPU server."""
        self._refuse_cold(warm)
        entry = self._models.get(name)
        if entry is None:
            return None
        with entry.admin_lock:
            if entry.closed or entry.batcher is None:
                return None
            used = {r.rid for r in entry.replicas}
            slot = 0
            while slot in used or entry.batcher.slot_busy(slot):
                # a quarantined worker (or a timed-out removal's zombie)
                # still holds its slot
                slot += 1
            mesh = (entry.build_kw or {}).get('mesh')
            if mesh is not None:
                from ..parallel.mesh import submesh_capacity
                if slot >= submesh_capacity(mesh, self._local_devices()):
                    return None       # no disjoint device set left
            self._add_replica(entry, slot, warm=warm)
            instrument.inc('serving.scale_ups')
            self._note_replicas(entry)
            return len(entry.replicas)

    def scale_down(self, name):
        """Remove the newest replica that is not a protected replacement,
        draining its in-flight flush at a flush boundary.  Never removes
        the last replica (unload does that).  Returns the new count, or
        None when nothing was removed."""
        entry = self._models.get(name)
        if entry is None:
            return None
        with entry.admin_lock:
            if entry.closed or len(entry.replicas) <= 1:
                return None
            sup = self._supervisor
            protected = sup.protected(name) if sup is not None else ()
            idx = None
            for i in range(len(entry.replicas) - 1, -1, -1):
                # never undo the repair the supervisor just paid for
                if entry.replicas[i].rid not in protected:
                    idx = i
                    break
            if idx is None:
                return None
            rep = entry.replicas.pop(idx)
            entry.batcher.remove_worker(rep.rid)
            instrument.drop_labeled_metrics(model=name,
                                            replica=str(rep.rid))
            instrument.inc('serving.scale_downs')
            self._note_replicas(entry)
            n = len(entry.replicas)
        del rep
        self._release_device_memory()
        return n

    def replica_count(self, name):
        return len(self._entry(name).replicas)

    def unload_model(self, name, drain=True, timeout=None):
        """Remove ``name``; ``drain=True`` serves what is queued first,
        ``drain=False`` fails it.  The drain is bounded by ``timeout``
        (default ``MXTPU_SERVE_DRAIN_TIMEOUT``): past it a wedged
        replica's requests fail with :class:`ReplicaQuarantinedError`."""
        with self._lock:
            entry = self._models.pop(name, None)
            sc = self._autoscaler
            sup = self._supervisor
        if entry is None:
            raise ModelNotFoundError('no model %r' % name)
        if sc is not None:
            sc.unwatch(name)
        if sup is not None:
            sup.unwatch(name)
        with entry.admin_lock:
            entry.closed = True
            entry.batcher.stop(drain=drain, timeout=timeout)
            entry.replicas = []
        # the model's whole labeled series family leaves the registry
        instrument.drop_labeled_metrics(model=name)
        self._note_models()
        del entry
        self._release_device_memory()

    def reload_model(self, name, prefix=None, epoch=None, symbol_json=None,
                     params=None, input_shapes=None, output_keys=None,
                     predictor=None, mesh=None, partition=None):
        """Hot-swap ``name``'s Predictor on EVERY replica.  Every
        replacement is built and warmed (captured) BEFORE the first swap;
        a flush in progress finishes on the old Predictor (the swap takes
        the replica lock its execute hook holds), later flushes run the
        new one.  The old Predictors' memory is released after.  The
        non-source fields (``output_keys``, ``mesh``, ``partition``) keep
        their stored values unless passed again."""
        entry = self._entry(name)
        with entry.admin_lock:
            if entry.closed:
                raise ModelNotFoundError('model %r is unloading' % name)
            kw = dict(entry.build_kw or {})
            if input_shapes is None:
                input_shapes = kw.get('input_shapes') or \
                    entry.predictor._input_shapes
            # the SOURCE fields replace wholesale; output_keys, mesh and
            # partition are kept unless passed again
            kw.update(prefix=prefix, epoch=epoch, symbol_json=symbol_json,
                      params=params, input_shapes=input_shapes)
            if output_keys is not None:
                kw['output_keys'] = output_keys
            if mesh is not None:
                kw['mesh'] = mesh
            if partition is not None:
                kw['partition'] = partition
            if predictor is not None:
                new = list(predictor) if isinstance(
                    predictor, (list, tuple)) else [predictor]
                if len(new) != len(entry.replicas):
                    raise MXNetError(
                        'reload with prebuilt predictors needs one '
                        'per replica (%d), got %d'
                        % (len(entry.replicas), len(new)))
                # the builder source now describes the PREVIOUS version:
                # drop it, so a later scale_up refuses loudly instead of
                # building a replica of the old model; mesh stays, for the
                # capacity rule
                old = entry.build_kw or {}
                entry.build_kw = {'input_shapes': input_shapes,
                                  'output_keys': old.get('output_keys'),
                                  'mesh': old.get('mesh'),
                                  'partition': old.get('partition')}
            else:
                new = [self._build_predictor(slot=rep.rid, **kw)
                       for rep in entry.replicas]
                entry.build_kw = kw
            for repl in new:
                self._warm_predictor(self._warm_rows(entry), repl)
            for rep, repl in zip(entry.replicas, new):
                with rep.lock:
                    self._ready(rep)
                    rep.predictor = repl
            entry.generation += 1
            entry.batcher.batch_inputs = set(new[0]._batch_inputs)
            first = new[0]
        instrument.inc('serving.reloads')
        del new, repl
        self._release_device_memory()
        return first

    def models(self):
        with self._lock:
            return sorted(self._models)

    def _entry(self, name):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise ModelNotFoundError('no model %r' % name)
        return entry

    # -- autoscaling --------------------------------------------------------

    def autoscale(self, name, slo_p99_ms=None, interval_s=None, **kw):
        """Enroll ``name`` with the closed-loop replica autoscaler (one
        per server, made and started on first use).  ``slo_p99_ms``
        defaults to ``MXTPU_SERVE_SLO_MS``, ``interval_s`` to
        ``MXTPU_SERVE_SCALE_INTERVAL``; ``kw`` goes to
        :meth:`ReplicaAutoscaler.watch`.  Raises without the metrics
        plane, whose histograms are the controller's only input.
        Returns the autoscaler (its :attr:`events` are the decision
        log)."""
        from .autoscaler import ReplicaAutoscaler
        self._entry(name)
        if not instrument.metrics_enabled():
            raise MXNetError(
                'autoscale needs the metrics plane: set MXTPU_METRICS=1 '
                'or instrument.set_metrics(True) before enrolling')
        if slo_p99_ms is None:
            slo_p99_ms = float(config.get('MXTPU_SERVE_SLO_MS'))
        if slo_p99_ms <= 0:
            raise MXNetError('autoscale needs slo_p99_ms > 0 (or '
                             'MXTPU_SERVE_SLO_MS set)')
        with self._lock:
            if self._autoscaler is None:
                self._autoscaler = ReplicaAutoscaler(
                    self, interval_s=interval_s)
            sc = self._autoscaler
        if interval_s is not None:
            sc.interval_s = float(interval_s)
        sc.watch(name, slo_p99_ms=slo_p99_ms, **kw)
        return sc

    @property
    def autoscaler(self):
        return self._autoscaler

    # -- supervision --------------------------------------------------------

    def supervise(self, name, wedge_ms=None, interval_s=None, start=True):
        """Enroll ``name`` with the replica supervisor (one per server,
        made on first use): a replica wedged past ``wedge_ms`` (default
        ``MXTPU_SERVE_WEDGE_MS``) or dead on an exception is quarantined,
        its in-flight requests replayed once at their lane's head, and a
        warmed replacement attached before the tear-down.
        ``start=False`` (or ``interval_s <= 0``) starts no thread: drive
        ``supervisor.tick()`` by hand.  Returns the supervisor."""
        from .supervisor import FleetSupervisor
        self._entry(name)
        with self._lock:
            if self._supervisor is None:
                self._supervisor = FleetSupervisor(
                    self, interval_s=interval_s)
            sup = self._supervisor
        if interval_s is not None:
            sup.interval_s = float(interval_s)
        sup.watch(name, wedge_ms=wedge_ms, start=start)
        return sup

    @property
    def supervisor(self):
        return self._supervisor

    # -- request path -------------------------------------------------------

    def submit(self, name, priority=None, deadline_ms=None, **inputs):
        """Enqueue one request; returns a Future of the list of
        per-output numpy arrays (sliced to the request's rows).
        ``priority='interactive'`` rides the express lane;
        ``deadline_ms`` (default ``MXTPU_SERVE_DEADLINE_MS``; 0: none)
        bounds the wait, past which the request fails with
        :class:`DeadlineExceededError`, never executed.  Raises
        :class:`ServerOverloadedError` when shedding."""
        return self._entry(name).batcher.submit(inputs,
                                                priority=priority,
                                                deadline_ms=deadline_ms)

    def predict(self, name, timeout=None, priority=None,
                deadline_ms=None, **inputs):
        """Blocking :meth:`submit`."""
        if timeout is None:
            timeout = config.get('MXTPU_SERVE_REQUEST_TIMEOUT')
        return self.submit(name, priority=priority,
                           deadline_ms=deadline_ms,
                           **inputs).result(timeout=timeout)

    # -- maintenance --------------------------------------------------------

    def pause(self, name):
        self._entry(name).batcher.pause()

    def resume(self, name):
        self._entry(name).batcher.resume()

    def stats(self):
        """The ``serving.*`` slice of the metrics registry (kinds with no
        such series are left out)."""
        snap = instrument.metrics_snapshot()
        out = {}
        for kind in ('counters', 'gauges', 'histograms'):
            vals = {k: v for k, v in (snap.get(kind) or {}).items()
                    if k.startswith('serving.')}
            if vals:
                out[kind] = vals
        return out

    def close(self, drain=True, timeout=None):
        with self._lock:
            self._closed = True
            names = list(self._models)
            sc = self._autoscaler
            self._autoscaler = None
            sup = self._supervisor
            self._supervisor = None
        if sc is not None:
            sc.stop()
        if sup is not None:
            sup.stop()
        for name in names:
            try:
                self.unload_model(name, drain=drain, timeout=timeout)
            except ModelNotFoundError:
                pass

    def drain(self, timeout=None, reason='drain'):
        """Bounded graceful drain, the SIGTERM path: stops admission and
        the control threads (autoscaler, supervisor), flushes every
        model's lanes within ONE shared ``timeout`` (default
        ``MXTPU_SERVE_DRAIN_TIMEOUT``; requests left in flight on a
        wedged replica fail typed past it), then commits the snapshot
        ``{'reason', 'models', 'stats', 'drain_secs',
        'autoscaler_events', 'supervisor_events', 'servewatch',
        'flight_path'}`` through the flight recorder (installed from
        ``MXTPU_FLIGHT_RECORDER`` if need be; ``flight_path`` is None
        when there is none) and returns it."""
        if timeout is None:
            timeout = float(config.get('MXTPU_SERVE_DRAIN_TIMEOUT'))
        t0 = time.monotonic()
        t_end = t0 + max(0.0, float(timeout))
        with self._lock:
            names = list(self._models)
            sc = self._autoscaler
            sup = self._supervisor
        snap = {
            'reason': reason,
            'models': names,
            # before the unloads drop the per-model labeled series
            'stats': self.stats(),
        }
        self.close(drain=True,
                   timeout=max(0.0, t_end - time.monotonic()))
        snap['drain_secs'] = time.monotonic() - t0
        # the rings survive close(): read them after, so repairs and
        # postmortems of the drain itself are in
        snap['autoscaler_events'] = list(sc.events) if sc is not None \
            else []
        snap['supervisor_events'] = list(sup.events) if sup is not None \
            else []
        snap['servewatch'] = {
            'decisions': servewatch.decisions(),
            'supervision': servewatch.supervision_events(),
            'flushes': servewatch.flushes(),
            'postmortems': servewatch.postmortems(),
        }
        rec = health.flight_recorder()
        if rec is None:
            rec = health.install_flight_recorder()
        if rec is not None:
            rec.dump('serve-%s' % reason, extra=snap)
            snap['flight_path'] = rec.durable_path('serve-%s' % reason)
        else:
            snap['flight_path'] = None
        instrument.inc('serving.drains')
        return snap

    def install_sigterm_drain(self, timeout=None):
        """Install a SIGTERM handler that runs :meth:`drain` (bounded),
        then chains the previous handler, or re-raises with the default
        disposition so the process still dies of SIGTERM.  Main thread
        only (``signal.signal``); returns True when installed."""
        import os
        import signal
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            try:
                self.drain(timeout=timeout, reason='sigterm')
            except Exception:      # noqa: BLE001 - still die of SIGTERM
                _log.exception('serving: drain on SIGTERM failed')
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=False)
        return False


def _on_stream(stream):
    """The replica's stream as the current one (no stream: the host)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)
