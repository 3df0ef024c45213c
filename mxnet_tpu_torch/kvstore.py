"""KVStore — key-value parameter synchronization; the port of
``mxnet_tpu/kvstore.py`` (reference ``include/mxnet/kvstore.h:26-286``,
``src/kvstore/kvstore_local.h``, ``kvstore_dist.h``).

- ``local`` / ``device``: in-process aggregation of per-context values.
  Each key's values are summed on the first value's device in one
  stacked sum (the reference's ``CommCPU``/``CommDevice`` merge buffer,
  ``src/kvstore/comm.h:61-360``), then the updater, when set, runs on the
  stored copy (``kvstore_local.h:50-127``).  A ``Module`` over a context
  list pushes each executor's gradient here.
- ``dist_sync``: every process holds the whole store, the locally-reduced
  values are summed across processes by ``torch.distributed``
  (``parallel/collectives.py``: NCCL where each rank has its own card,
  gloo otherwise) and the updater runs identically on every rank — the
  reference's sync mode (``kvstore_dist_server.h:179-197``) with
  replicated servers.  Rank and size are ``torch.distributed``'s.
- ``dist_async``: apply-on-arrival updates cannot ride a collective, so a
  host-side TCP server co-located with rank 0 owns the master weights and
  runs the optimizer per push as it lands (:class:`DistAsyncKVStore`,
  ``kvstore_server.py``, ``kvstore_dist_server.h:199-207``).
"""
from __future__ import annotations

import os
import pickle
import time
import uuid
from typing import Dict, List

import torch

from . import config
from . import instrument
from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray

__all__ = ['KVStore', 'DistKVStore', 'DistAsyncKVStore', 'create']


def _record_transfer(op, vals):
    """Metrics hook shared by every push/pull entry point: count the
    call and the bytes in its value list (flat or nested).  ``op`` is
    'push' or 'pull'; no-op when the metrics registry is off."""
    if not instrument.metrics_enabled():
        return
    total = 0
    for v in vals:
        for a in (v if isinstance(v, (list, tuple)) else [v]):
            total += a.size * a.handle.element_size()
    instrument.inc('kvstore.pushes' if op == 'push' else 'kvstore.pulls')
    instrument.inc('kvstore.%s_bytes' % op, total)


def _ctype_key_value(key, vals):
    if isinstance(key, (list, tuple)):
        assert len(key) == len(vals)
        return list(key), list(vals)
    return [key], [vals]


class KVStore(object):
    """Single-process store: the ``local`` and ``device`` types
    (reference kvstore.py:49-220 + kvstore_local.h)."""

    def __init__(self, kind='local'):
        self._kind = kind
        self._store: Dict[object, NDArray] = {}
        self._updater = None
        self._control_plane_only = False

    # -- control-plane demotion --------------------------------------------
    def demote_to_control_plane(self):
        """A mesh-active fit reduces gradients inside its step, so the
        store's data plane has no job left: only ``barrier``, heartbeats,
        telemetry and membership stay live, and ``push``/``pull`` refuse
        instead of reducing twice what the step already reduced."""
        self._control_plane_only = True
        instrument.inc('kvstore.demotions')

    @property
    def control_plane_only(self):
        return self._control_plane_only

    def _check_data_plane(self, op):
        if self._control_plane_only:
            raise MXNetError(
                'kvstore.%s: this store is demoted to control-plane '
                'duties (a device mesh is active — gradient reduction '
                'runs inside the step)' % op)

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        keys, vals = _ctype_key_value(key, value)
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if k in self._store:
                raise MXNetError('duplicate init of key ' + str(k))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Aggregate (sum) pushed values; run the updater on the stored
        copy if set, else the merged value replaces the store
        (``local = merged``, kvstore_local.h:59-71)."""
        self._check_data_plane('push')
        keys, vals = _ctype_key_value(key, value)
        _record_transfer('push', vals)
        with instrument.span('kvstore.push', cat='kvstore'):
            for k, v in zip(keys, vals):
                if not isinstance(v, (list, tuple)):
                    v = [v]
                merged = self._reduce(v)
                if k not in self._store:
                    raise MXNetError('please init key %s first' % str(k))
                if self._updater is not None:
                    self._updater(k, merged, self._store[k])
                else:
                    self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        """Broadcast the stored value into every output array
        (kvstore_local.h:79-95)."""
        assert out is not None
        self._check_data_plane('pull')
        keys, outs = _ctype_key_value(key, out)
        _record_transfer('pull', outs)
        with instrument.span('kvstore.pull', cat='kvstore'):
            for k, o in zip(keys, outs):
                if not isinstance(o, (list, tuple)):
                    o = [o]
                src = self._store[k]
                for dst in o:
                    _copy_into(src, dst)

    def _reduce(self, vals: List[NDArray]) -> NDArray:
        """Sum the per-context values on the first one's device, in one
        stacked sum (the reference's merge buffer, comm.h:321-348)."""
        if len(vals) == 1:
            return vals[0].copy()
        dev = vals[0].handle.device
        stacked = torch.stack([v.handle.to(dev) for v in vals])
        return NDArray(stacked.sum(dim=0), vals[0].context)

    # -- updater/optimizer -------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """In dist mode the reference pickles the optimizer to servers
        (kvstore.py:103-135); locally it installs the updater."""
        if 'dist' in self._kind and self.num_workers > 1:
            self._send_command_to_servers(0, pickle.dumps(optimizer, 0))
        else:
            self.set_updater(opt.get_updater(optimizer))

    # -- topology ----------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError('Cannot save states for distributed training')
        from . import resilience
        with resilience.atomic_replace(fname) as tmp:
            with open(tmp, 'wb') as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError('Cannot load states for distributed training')
        with open(fname, 'rb') as fin:
            self._updater.set_states(fin.read())

    def _send_command_to_servers(self, head, body):
        pass


def _copy_into(src, dst):
    """``src``'s values into ``dst``'s own tensor, in place (its device
    and dtype kept): a bound executor keeps reading the same tensor."""
    with torch.no_grad():
        dst.handle.copy_(src.handle)


class DistKVStore(KVStore):
    """``dist_sync`` over ``torch.distributed`` (replaces the ps-lite
    worker, ``kvstore_dist.h:28-318``): every worker pushes, values
    all-reduce across processes, and the updater runs identically
    everywhere — replicated servers with the observable behaviour of the
    reference's sync mode (``kvstore_dist_server.h:179-197``)."""

    def __init__(self, kind):
        super().__init__(kind)
        from .parallel import collectives
        self.backend = collectives.init_distributed()
        self._nproc = collectives.world_size()
        self._rank = collectives.rank()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def _reduce(self, vals):
        local = super()._reduce(vals)
        if self._nproc == 1:
            return local
        from .parallel.collectives import allreduce_hosts
        return NDArray(allreduce_hosts(local.handle), local.context)

    def push(self, key, value, priority=0):
        """Batched push: keys at or below MXNET_KVSTORE_BIGARRAY_BOUND
        elements reduce locally first and then cross processes as ONE
        flat all-reduce (``collectives.allreduce_hosts_batch``); bigger
        keys go one by one — the reference's policy
        (``kvstore_dist.h:277-299``): the long tail of small keys costs
        a collective's latency, not bytes."""
        self._check_data_plane('push')
        keys, vals = _ctype_key_value(key, value)
        if self._nproc == 1 or len(keys) <= 1:
            return super().push(key, value, priority)
        _record_transfer('push', vals)
        bound = int(config.get('MXNET_KVSTORE_BIGARRAY_BOUND'))
        with instrument.span('kvstore.push', cat='kvstore'):
            merged = []
            for k, v in zip(keys, vals):
                if not isinstance(v, (list, tuple)):
                    v = [v]
                if k not in self._store:
                    raise MXNetError('please init key %s first' % str(k))
                merged.append(KVStore._reduce(self, v))  # local values only
            from .parallel.collectives import (allreduce_hosts,
                                               allreduce_hosts_batch)
            small = [i for i, m in enumerate(merged) if m.size <= bound]
            summed = [None] * len(merged)
            batch_res = allreduce_hosts_batch(
                [merged[i].handle for i in small])
            for i, s in zip(small, batch_res):
                summed[i] = s
            for i, m in enumerate(merged):
                if summed[i] is None:
                    summed[i] = allreduce_hosts(m.handle)
            for k, s, m in zip(keys, summed, merged):
                arr = NDArray(s, m.context)
                if self._updater is not None:
                    self._updater(k, arr, self._store[k])
                else:
                    self._store[k] = arr

    def set_optimizer(self, optimizer):
        """Every process holds the whole store and sees the same reduced
        gradients, so the optimizer runs locally and identically on every
        rank: install the updater (the base class would ship it to
        ps-lite servers this store does not have, and a multi-worker fit
        would then store raw gradient sums as weights)."""
        self.set_updater(opt.get_updater(optimizer))

    def barrier(self):
        if self._nproc > 1:
            from . import iowatch
            from .parallel.collectives import host_barrier
            with instrument.span('kvstore.barrier', cat='wait'), \
                    iowatch.account('barrier'):
                host_barrier()


class DistAsyncKVStore(KVStore):
    """``dist_async``: apply-on-arrival updates with non-blocking pushes.

    The reference's async mode has the ps-lite server run the optimizer
    per push as it lands, with no aggregation barrier
    (``kvstore_dist_server.h:199-207``).  Here a host-side TCP server
    (:mod:`kvstore_server`) runs as a thread of the rank-0 worker, the
    way ps-lite co-located servers with workers.  ``push`` hands the
    locally-reduced value, as a host array, to the client's sender
    thread and returns; ``pull`` reads whatever the server has applied
    so far — the async staleness contract — into the outputs' own
    tensors."""

    def __init__(self, kind):
        super().__init__(kind)
        from . import kvstore_server as srv
        self._rank = int(config.get('MXTPU_PROCESS_ID'))
        self._nproc = int(config.get('MXTPU_NUM_PROCESSES'))
        addr = srv.server_addr_from_env()
        self._server = None
        if self._rank == 0:
            port = 0 if addr is None else int(addr.rsplit(':', 1)[1])
            try:
                self._server = srv.AsyncKVServer(
                    port=port, num_workers=self._nproc)
            except OSError as bind_err:
                # the port is taken: another co-located store's server
                # (fine) or a foreign service (the ping below tells)
                self._server = None
                self._bind_err = bind_err
            if addr is None:
                addr = '127.0.0.1:%d' % self._server.port
                os.environ['MXTPU_KV_SERVER_ADDR'] = addr
        assert addr is not None, \
            'dist_async workers need MXTPU_KV_SERVER_ADDR (tools/launch.py)'
        # a rank-tagged client id: a respawned worker gets a fresh one
        # (its replay watermark must not collide with its predecessor's)
        cid = 'rank%d-%s' % (self._rank, uuid.uuid4().hex)
        self._client = srv.AsyncKVClient(addr, client_id=cid)
        try:
            self._client.ping(timeout=15.0)
        except Exception as e:
            raise MXNetError(
                'the listener at %s does not speak the kv protocol '
                '(%s); is a foreign service bound to the port?'
                % (addr, e))
        self._client.start_heartbeat(self._rank)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def init(self, key, value):
        keys, vals = _ctype_key_value(key, value)
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):
                v = v[0]
            # worker 0 seeds the server; everyone records the key order
            if self._rank == 0:
                self._client.init(k, v.asnumpy())
            self._store[k] = v.copy()
        self.barrier()

    def push(self, key, value, priority=0):
        """NON-blocking: the locally-reduced value goes to the sender
        thread as a host array; the server applies it on arrival."""
        self._check_data_plane('push')
        keys, vals = _ctype_key_value(key, value)
        _record_transfer('push', vals)
        with instrument.span('kvstore.push', cat='kvstore'):
            for k, v in zip(keys, vals):
                if not isinstance(v, (list, tuple)):
                    v = [v]
                merged = super()._reduce(v)
                self._client.push(k, merged.asnumpy())

    def pull(self, key, out=None, priority=0):
        assert out is not None
        self._check_data_plane('pull')
        keys, outs = _ctype_key_value(key, out)
        _record_transfer('pull', outs)
        with instrument.span('kvstore.pull', cat='kvstore'):
            for k, o in zip(keys, outs):
                if not isinstance(o, (list, tuple)):
                    o = [o]
                cur = torch.from_numpy(self._client.pull(k))
                with torch.no_grad():
                    for dst in o:
                        dst.handle.copy_(cur)

    def set_optimizer(self, optimizer):
        """Pickle the optimizer to the server — the reference's flow
        (kvstore.py:103-135 → server ``CmdType::kController``)."""
        if self._rank == 0:
            self._client.set_optimizer_bytes(pickle.dumps(optimizer, 0))
        self.barrier()

    def set_updater(self, updater):
        raise MXNetError('dist_async applies updates on the server; use '
                         'set_optimizer')

    def barrier(self):
        """Flush-then-barrier: on a clean link the flush is an ack wait,
        on a lossy one it replays un-acked pushes first — so "barrier
        passed" always means "my pushes are applied"."""
        timeout = config.get('MXTPU_KV_BARRIER_TIMEOUT')
        t_end = time.monotonic() + timeout   # ONE budget for flush+wait
        with instrument.span('kvstore.barrier', cat='wait'):
            if not self._client.flush(timeout=timeout):
                instrument.inc('kvstore.flush_timeouts')
                raise MXNetError(
                    'kvstore flush timed out: %d push(es) still un-acked '
                    'after %.0fs — refusing to enter the barrier with '
                    'gradients possibly un-applied'
                    % (self._client.pending_pushes, timeout))
            self._client.barrier(
                timeout=max(1.0, t_end - time.monotonic()))

    def num_dead_node(self, node_id=0, timeout_s=5.0):
        """Count workers whose heartbeats stopped
        (``kvstore_dist.h:151-156`` ``get_num_dead_node``)."""
        return self._client.num_dead_nodes(timeout_s)

    def telemetry(self):
        """The server's merged cluster telemetry view: per-rank
        registries carried by the heartbeats, cluster-summed counters
        and the currently-dead ranks."""
        return self._client.telemetry()

    @property
    def is_recovery(self):
        """Whether this worker restarted into an existing job
        (``kvstore_dist.h:158-160``; the launcher sets the flag when it
        respawns a rank)."""
        return bool(config.get('MXTPU_IS_RECOVERY'))

    def save_optimizer_states(self, fname):
        raise MXNetError('Cannot save states for distributed training')

    def load_optimizer_states(self, fname):
        raise MXNetError('Cannot load states for distributed training')

    def leave(self):
        """Stop heartbeating WITHOUT closing: this worker then reads as
        dead to the server, so its peers' barriers degrade around it.
        Called when fit() unwinds with an error in a process that stays
        alive."""
        self._client.stop_heartbeat()

    def close(self):
        """Drain and close.  Returns the number of pushes that could not
        be delivered (0 on a clean shutdown)."""
        self._client.stop_heartbeat()
        undelivered = self._client.close()
        if self._server is not None:
            self._server.stop()
        return undelivered


def create(name='local'):
    """Factory (reference ``src/kvstore/kvstore.cc:17-45``): ``local`` /
    ``device`` → in-process; ``dist_sync*`` → synchronous cross-process
    collectives; ``dist_async`` → the apply-on-arrival server."""
    if not isinstance(name, str):
        raise TypeError('name must be a string')
    if 'dist' in name and 'async' in name:
        return DistAsyncKVStore(name)
    if 'dist' in name:
        return DistKVStore(name)
    return KVStore(name)
