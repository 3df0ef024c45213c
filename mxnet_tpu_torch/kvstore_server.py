"""Async key-value server — apply-on-arrival parameter updates; the
port of ``mxnet_tpu/kvstore_server.py``, whole: the same wire protocol,
so a port client and a JAX server (and the other way round) exchange
init, push, pull and barrier.

The reference's ``dist_async`` mode runs ps-lite server processes that
apply each worker's push the moment it arrives, with no cross-worker
aggregation barrier (``src/kvstore/kvstore_dist_server.h:199-207``
``DataHandleDefault``: merge buffer skipped, ``exec_.Exec(updater)`` per
request).  A collective is synchronous by construction, so async
semantics ride a host-side TCP server instead: it owns the master copy
of every key (numpy arrays), applies the optimizer per push on arrival
(the port's updater over CPU torch tensors made from the stored arrays,
under the key's lock) and serves pulls of the current, possibly
mid-flight, weights.

Topology matches ps-lite's co-location default: the server runs as a
thread inside the rank-0 worker (the reference launcher started servers
next to workers; ``tools/launch.py`` here publishes
``MXTPU_KV_SERVER_ADDR`` the same way it publishes the coordinator).

Wire protocol: length-prefixed pickle frames; tensors travel as raw
numpy.  Per-connection ordering is preserved (one socket per worker),
matching ps-lite's per-key ordering guarantee between a single worker
and the server.  Frame shapes:

- ``('hello', client_id)`` — connection handshake, re-sent on every
  reconnect; no reply.
- ``('push', seq, key, arr)`` — sequence-numbered push, acknowledged
  asynchronously with ``('ack', seq)`` (or ``('perr', seq, msg)`` on a
  handler error).  The client keeps every un-acked push for replay, so
  a dropped connection or a restarted server loses no gradients — the
  ps-lite van resend protocol (``ps-lite/src/van.cc``).
- ``('hb', rank)`` — heartbeat, no reply (``kvstore_dist.h:151-160``).
  Protocol v2 extension: ``('hb', rank, ('mv2', delta))`` piggybacks a
  compact metrics delta (changed instrument counters/gauges/timers
  since the last beat) on the same frame — versioned by the ``'mv2'``
  tag and structurally ignored by v2 servers predating it (they index
  ``msg[1]`` only), so mixed-version clusters keep heartbeating.  The
  server merges per-rank deltas into a cluster telemetry view
  queryable via the ``telemetry`` RPC and, under
  ``MXTPU_TELEMETRY_DIR``, served as a JSON status file + Prometheus
  text exposition (docs/observability.md).  Protocol v3 appends the
  sender's admission *generation* — ``('hb', rank, delta_or_None,
  gen)`` — so a zombie original beating a rank that was re-assigned
  to a replacement worker is ignored instead of resurrecting the dead
  member (elastic membership, docs/resilience.md; older servers never
  read past the delta, older clients simply carry no tag).
- ``('rpc', nonce, inner)`` — request/response ops (pull, init,
  barrier, telemetry, ...), answered with ``('rpcr', nonce, reply)``;
  the nonce lets the client retry a timed-out RPC and discard stale
  replies.

Fault tolerance (docs/resilience.md): RPCs carry per-attempt timeouts
and per-op deadlines instead of the seed's unbounded ``_respq.get()``;
the client transparently redials a lost server and replays pending
pushes (deduplicated server-side by per-client sequence watermarks,
persisted with the store when ``MXTPU_KV_SERVER_BACKING`` is set);
``barrier`` excludes heartbeat-dead ranks so one crashed worker degrades
the job instead of hanging it.  Every recovery event is counted in the
:mod:`instrument` registry (``kvstore.retries``,
``kvstore.reconnects``, ``kvstore.rpc_timeouts``, ...), and the
:mod:`resilience` fault plan (``MXTPU_FAULTS``) can drop, delay or
sever frames at the marked points to drive the chaos tests.

The cross-rank planes hook in as in the reference: a merged view that
names a straggler calls ``health.note_skew`` (``MXTPU_SKEW_WARN_PCT``),
and the client's barrier wait lands in ``commwatch.barrier_wait``.  The
server answers the membership RPCs
(join, membership, resize, ckpt_vote); their client side is
``elastic.py``'s, which is not ported yet.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import pickle
import queue
import socket
import struct
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np

from . import config
from . import instrument
from . import resilience

_HDR = struct.Struct('!Q')


def _send_frame(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError('kvstore server connection closed')
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


def _hard_close(sock):
    """shutdown + close: plain close() does NOT unblock another thread
    parked in recv/send on the same socket (the fd release is deferred
    until the syscall returns), shutdown() does."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class BarrierTimeout(RuntimeError):
    """Server-side barrier deadline expired (MXTPU_KV_BARRIER_TIMEOUT)."""


class StaleGenerationError(RuntimeError):
    """A message from a worker whose rank was re-assigned at a newer
    cluster generation (elastic membership, docs/resilience.md): the
    zombie original must fail fast, not corrupt the replacement's
    training — its pushes are rejected, its heartbeats ignored, its
    data-plane RPCs answered with this error."""


def compute_step_skew(ranks):
    """Cross-rank straggler attribution from a merged telemetry view's
    per-rank ``comm.step_time`` histograms (the MXTPU_COMMWATCH step-
    cadence signal riding the heartbeat piggyback).

    Returns ``(skew, laggard)``: ``skew`` is the slowest rank's mean
    step time over the cluster MEDIAN, minus one (0.0 = perfectly even;
    0.5 = the laggard runs 50% slower than the typical rank — the
    number a synchronous data-parallel step is dragged down by), and
    ``laggard`` names it: ``{'rank', 'mean_step_secs',
    'median_step_secs', 'pct_over_median', 'means'}``.  ``(0.0, None)``
    when fewer than two ranks reported a usable histogram — skew is a
    relative notion.  Pure function (unit-tested directly; the server
    folds it into :meth:`AsyncKVServer.telemetry_view`)."""
    means = {}
    for r, snap in ranks.items():
        h = (snap.get('histograms') or {}).get('comm.step_time') or {}
        try:
            count = float(h.get('count', 0))
            total = float(h.get('sum', 0.0))
        except (TypeError, ValueError):
            continue
        if count >= 2 and total > 0:
            means[r] = total / count
    if len(means) < 2:
        return 0.0, None
    vals = sorted(means.values())
    mid = len(vals) // 2
    median = vals[mid] if len(vals) % 2 else \
        0.5 * (vals[mid - 1] + vals[mid])
    slow = max(means, key=means.get)
    if median <= 0:
        return 0.0, None
    skew = max(0.0, means[slow] / median - 1.0)
    return skew, {'rank': slow,
                  'mean_step_secs': means[slow],
                  'median_step_secs': median,
                  'pct_over_median': 100.0 * skew,
                  'means': {str(r): m for r, m in sorted(means.items())}}


def compute_cluster_goodput(ranks):
    """Cluster goodput attribution from a merged telemetry view's
    per-rank ``goodput.fraction`` gauges (the MXTPU_IOWATCH ledger
    riding the heartbeat piggyback).

    Returns ``(min_fraction, worst)``: the BINDING rank's goodput
    fraction (a synchronous job trains no faster than its least-fed
    rank) and ``worst`` names it — ``{'rank', 'fraction', 'fractions'}``
    — or ``(0.0, None)`` when no rank reported one yet.  Pure function
    (unit-tested directly; the server folds it into
    :meth:`AsyncKVServer.telemetry_view` as the ``cluster.goodput``
    gauge)."""
    fracs = {}
    for r, snap in ranks.items():
        g = (snap.get('gauges') or {}).get('goodput.fraction')
        try:
            if g is not None:
                fracs[r] = float(g)
        except (TypeError, ValueError):
            continue
    if not fracs:
        return 0.0, None
    worst = min(fracs, key=fracs.get)
    return fracs[worst], {'rank': worst,
                          'fraction': fracs[worst],
                          'fractions': {str(r): f for r, f in
                                        sorted(fracs.items())}}


class AsyncKVServer(object):
    """The server side: owns the master weights, applies pushes on
    arrival (one lock per key — concurrent pushes to different keys
    update in parallel, same-key pushes serialize, exactly the ps-lite
    executor discipline).

    ``backing`` (default: the ``MXTPU_KV_SERVER_BACKING`` knob) names a
    file the store + per-client replay watermarks are committed to
    atomically after every ``sync_every``-th applied push; a restarted
    server restores from it, so worker replay of un-acked pushes
    completes exactly-once (the ack is only sent after the commit that
    covers the push)."""

    def __init__(self, port=0, num_workers=1, backing=None, sync_every=None):
        self._store: Dict[object, np.ndarray] = {}
        self._locks: Dict[object, threading.Lock] = {}
        self._store_lock = threading.Lock()
        self._updater = None
        self._optimizer_bytes = None
        self._num_workers = num_workers
        # RLock: membership eviction runs both FROM the barrier wait
        # loop (which already holds the condition) and from join/
        # membership RPC threads (which must take it to mutate the
        # waiter set) — the lock order everywhere is barrier_cv then
        # member_lock, never the reverse
        self._barrier_lock = threading.RLock()
        self._barrier_gen = 0
        self._barrier_cv = threading.Condition(self._barrier_lock)
        # elastic membership (docs/resilience.md): the authoritative
        # promotion of the passive heartbeat dead-rank view.  Armed by
        # MXTPU_ELASTIC or by the first join/membership RPC — unarmed
        # servers never evict, preserving the PR-2 semantics exactly
        # (a rank whose beats resume is simply live again).
        self._elastic_armed = bool(config.get('MXTPU_ELASTIC'))
        self._member_lock = threading.RLock()
        self._generation = 0
        # the cluster's SEAT SET: resize does not renumber surviving
        # ranks, so after a shrink the live rank ids need not be
        # compact in [0, num_workers) — every membership computation
        # (eviction eligibility, live sets, barrier expectations)
        # consults the seats, never range(num_workers)
        self._seats = set(range(num_workers))
        self._members: Dict[int, str] = {}       # rank -> owning client
        self._vacant: Dict[int, float] = {}      # evicted rank -> t_evict
        self._rank_fence: Dict[int, int] = {}    # rank -> min live gen
        self._fenced: set = set()                # evicted client ids
        self._fenced_seats: Dict[str, int] = {}  # evicted client -> rank
        self._rank_epochs: Dict[int, int] = {}   # rank -> reported epoch
        self._ckpt_votes: Dict[int, list] = {}   # rank -> loadable epochs
        self._health_alert = None                # cluster health verdict
        self._health_alert_seq = 0
        # recent membership events (evict/join/resize), generation-
        # tagged: a coordinator whose poll cadence is slower than an
        # evict→join pair still sees the repair happened (a join can
        # claim a vacancy ATOMICALLY with the sweep that opened it, so
        # the instantaneous vacancy view alone can miss it entirely)
        self._member_events = collections.deque(maxlen=32)
        self._barrier_waiters: Dict[object, object] = {}  # key -> bcount
        self._barrier_done: Dict[object, int] = {}        # key -> bcount
        self._applied = 0           # total pushes applied (introspection)
        self._last_seen: Dict[int, float] = {}   # rank -> last heartbeat
        # per-client receiver window: contiguous watermark + the set of
        # out-of-order applied seqs above it (frame drops on a lossy
        # link leave gaps, so a bare high-watermark would mis-classify
        # replayed gap-fillers as duplicates).  One lock per client
        # keeps apply + window advance atomic.
        self._acked: Dict[str, int] = {}
        self._acked_gaps: Dict[str, set] = {}
        self._client_locks: Dict[str, threading.Lock] = {}
        # disconnect bookkeeping for per-client state GC: worker
        # respawns mint fresh uuid-tagged client ids, so without
        # pruning, _acked/_barrier_done grow (and re-serialize into
        # every backing commit) forever on a long-running job
        self._conn_ids: Dict[int, str] = {}       # id(conn) -> client_id
        self._client_gone: Dict[str, float] = {}  # client_id -> t_gone
        # serializes backed applies against the persist snapshot: a
        # commit captured between another client's store write and its
        # watermark advance would either double-apply or drop that
        # push after a restore (the exactly-once guarantee).  Held only
        # when a backing file is configured — the unbacked fast path
        # keeps full cross-client parallelism.
        # cluster telemetry: per-rank metric registries merged from the
        # heartbeat piggyback deltas (protocol v2 'mv2' extension);
        # served by the telemetry RPC and, under MXTPU_TELEMETRY_DIR,
        # as cluster_status.json + cluster_status.prom
        self._telemetry: Dict[int, dict] = {}
        self._telemetry_lock = threading.Lock()
        self._status_dir = config.get('MXTPU_TELEMETRY_DIR') or None
        self._status_last = 0.0
        self._commit_lock = threading.RLock()
        self._backing = (backing if backing is not None
                         else (config.get('MXTPU_KV_SERVER_BACKING') or None))
        self._sync_every = max(1, int(sync_every if sync_every is not None
                               else config.get('MXTPU_KV_SERVER_SYNC_EVERY')))
        if self._backing:
            self._restore()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(('0.0.0.0', port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads = []
        self._conns = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- persistence -------------------------------------------------------
    def _restore(self):
        try:
            with open(self._backing, 'rb') as f:
                state = pickle.load(f)
        except FileNotFoundError:
            return
        except Exception as e:
            logging.warning('kv server backing %s unloadable (%s); '
                            'starting empty', self._backing, e)
            return
        self._store = dict(state.get('store', {}))
        self._acked = dict(state.get('acked', {}))
        self._acked_gaps = {k: set(v) for k, v in
                            state.get('acked_gaps', {}).items()}
        self._barrier_done.update(state.get('barrier_done', {}))
        self._applied = int(state.get('applied', 0))
        # restored ids start on the GC clock: respawned workers mint
        # fresh uuid-tagged ids, so previous generations would otherwise
        # accrete in every commit forever (hello clears returners)
        now = time.time()
        for cid in set(self._acked) | set(self._barrier_done):
            self._client_gone[cid] = now
        # elastic membership epoch: generation + fences survive a
        # server restart — otherwise a zombie whose rank was
        # re-assigned before the crash would be re-admitted by the
        # restored server (membership bindings re-establish from the
        # live ranks' heartbeats/polls)
        self._generation = int(state.get('generation', 0))
        self._rank_fence = {int(k): int(v) for k, v in
                            (state.get('rank_fence') or {}).items()}
        self._fenced = set(state.get('fenced') or ())
        self._fenced_seats = {str(k): int(v) for k, v in
                              (state.get('fenced_seats') or {}).items()}
        self._vacant = {int(k): float(v) for k, v in
                        (state.get('vacant') or {}).items()}
        if self._generation > 0:
            # a resize/evict epoch was in play: the persisted expected
            # count + seat set are the authoritative ones, not the
            # respawn argument
            self._num_workers = int(state.get('num_workers',
                                              self._num_workers))
            self._seats = set(int(r) for r in
                              state.get('seats',
                                        range(self._num_workers)))
        self._optimizer_bytes = state.get('optimizer')
        if self._optimizer_bytes is not None:
            from . import optimizer as opt
            self._updater = opt.get_updater(
                pickle.loads(self._optimizer_bytes))
        logging.info('kv server restored %d keys / %d applied pushes '
                     'from %s', len(self._store), self._applied,
                     self._backing)

    def _gc_clients(self):
        """Drop replay/barrier state of clients disconnected long past
        any plausible reconnect (2x the reconnect deadline, 10-minute
        floor): respawned workers mint fresh ids, so stale entries only
        bloat memory and every backing commit."""
        if not self._client_gone:
            return
        horizon = max(600.0,
                      2 * config.get('MXTPU_KV_RECONNECT_DEADLINE'))
        now = time.time()
        for cid, t_gone in list(self._client_gone.items()):
            if now - t_gone > horizon:
                self._client_gone.pop(cid, None)
                self._acked.pop(cid, None)
                self._acked_gaps.pop(cid, None)
                self._client_locks.pop(cid, None)
                self._barrier_done.pop(cid, None)

    # -- elastic membership (docs/resilience.md) ---------------------------
    def _sweep_locked(self):
        """Promote heartbeat-dead ranks into authoritative evictions.
        Runs inside every join/membership/ckpt_vote RPC and every
        barrier wait pass — there is deliberately NO autonomous server
        timer: an armed server with no polling clients and no barriers
        evicts nobody.  No-op until the elastic plane is armed
        (MXTPU_ELASTIC on the server, or the first join/membership
        RPC): unarmed servers keep the PR-2 passive semantics where a
        rank whose beats resume is simply live again.  Caller holds
        barrier_cv + member_lock."""
        if not self._elastic_armed:
            return
        dead = self._dead_ranks(config.get('MXTPU_KV_DEAD_TIMEOUT'))
        for rank in dead:
            # only REAL seats evict: a ghost rank that never held a
            # seat (a stray/mistagged beat) must not open a vacancy a
            # joiner could be seated on — and a surviving rank whose
            # id is >= the post-shrink worker count still evicts
            # (seats, not range(num_workers))
            if rank in self._seats and rank not in self._vacant:
                self._evict_locked(rank)

    def _evict_locked(self, rank):
        """Evict one rank: bump the cluster generation, fence the
        owning client (its pushes/RPCs reject, its beats are ignored),
        open the vacancy for a replacement, and drop the rank's stale
        barrier registration so it can neither hold a barrier nor fill
        a live slot.  Caller holds barrier_cv + member_lock."""
        self._generation += 1
        self._rank_fence[rank] = self._generation
        owner = self._members.pop(rank, None)
        if owner is not None:
            self._fenced.add(owner)
            self._fenced_seats[owner] = rank
        self._vacant[rank] = time.time()
        self._last_seen.pop(rank, None)
        self._rank_epochs.pop(rank, None)
        for w, (_bc, rk) in list(self._barrier_waiters.items()):
            if rk == rank:
                self._barrier_waiters.pop(w, None)
        self._member_events.append(
            {'kind': 'evict', 'rank': rank,
             'generation': self._generation, 'time': time.time()})
        instrument.inc('kvstore.evictions')
        instrument.decision(
            'kvserver', 'evict', severity='warn',
            reason='rank %s evicted at generation %d (heartbeats '
                   'stale)' % (rank, self._generation),
            rank=rank, generation=self._generation)
        logging.warning(
            'kv server: rank %s evicted at generation %d (heartbeats '
            'stale past %.1fs) — vacancy open for a replacement',
            rank, self._generation, config.get('MXTPU_KV_DEAD_TIMEOUT'))
        self._barrier_cv.notify_all()
        if self._backing:
            self._persist()

    def _bind_locked(self, rank, client_id):
        """Record rank -> client ownership.  Fenced clients and open
        vacancies never bind (a vacancy is claimed only through the
        join RPC), and a LIVE owner's binding is never stolen — but a
        binding whose recorded owner has no connection left is stale
        (an in-place respawn minted a fresh client id before any
        eviction) and rebinds to the live claimant, so a later
        eviction fences the client actually holding the seat, not its
        long-dead predecessor."""
        if rank is None or client_id is None:
            return
        if client_id in self._fenced or rank in self._vacant:
            return
        cur = self._members.get(rank)
        if cur is None or cur == client_id or \
                cur not in list(self._conn_ids.values()):
            self._members[rank] = client_id

    def _vacant_set(self):
        return set(self._vacant)

    def _topology_locked(self):
        """The membership view one join/membership reply carries.
        Caller holds member_lock."""
        dead = set(self._dead_ranks(config.get('MXTPU_KV_DEAD_TIMEOUT')))
        now = time.time()
        return {
            'generation': self._generation,
            'num_workers': self._num_workers,
            'seats': sorted(self._seats),
            'members': {r: {'live': r not in dead}
                        for r in sorted(self._members)},
            'vacant': {r: now - t
                       for r, t in sorted(self._vacant.items())},
            'dead': sorted(dead),
            'cluster_epoch': max(self._rank_epochs.values(), default=-1),
            'events': [dict(e) for e in self._member_events],
        }

    def _join(self, client_id):
        """Admit a replacement worker: assign the oldest vacancy, bump
        the generation, un-fence the joiner (a transiently-evicted
        original may reclaim its own seat), and start its liveness
        clock so the admission itself counts as a beat."""
        self._elastic_armed = True
        with self._barrier_cv:
            with self._member_lock:
                self._sweep_locked()
                # idempotent under RPC re-send (a 'joined' reply lost
                # to a drop/sever makes the client retry): an
                # already-seated client gets ITS seat back, never a
                # second one
                for r, cid in self._members.items():
                    if cid == client_id:
                        return ('joined', r, self._generation,
                                self._num_workers,
                                self._topology_locked())
                if not self._vacant:
                    return ('no-vacancy', self._generation,
                            self._num_workers)
                # a transiently-evicted original reclaims ITS OWN seat
                # when it is still open (beating another vacancy's rank
                # would orphan this client's data/identity); fresh
                # spares take the lowest vacancy
                prev = self._fenced_seats.get(client_id)
                rank = prev if prev in self._vacant else min(self._vacant)
                del self._vacant[rank]
                self._generation += 1
                self._members[rank] = client_id
                self._fenced.discard(client_id)
                self._fenced_seats.pop(client_id, None)
                self._last_seen[rank] = time.time()
                self._member_events.append(
                    {'kind': 'join', 'rank': rank,
                     'generation': self._generation, 'time': time.time()})
                instrument.inc('kvstore.joins')
                instrument.decision(
                    'kvserver', 'join',
                    reason='client %s joined as rank %d at generation '
                           '%d' % (client_id, rank, self._generation),
                    rank=rank, generation=self._generation)
                logging.info(
                    'kv server: client %s joined as rank %d at '
                    'generation %d', client_id, rank, self._generation)
                self._barrier_cv.notify_all()
                topo = self._topology_locked()
                if self._backing:
                    self._persist()
                return ('joined', rank, self._generation,
                        self._num_workers, topo)

    def _membership(self, client_id, rank, epoch):
        """The membership poll: arm the plane, sweep, bind the caller's
        rank, record its epoch progress, and return the current view
        (generation, vacancies + ages, dead ranks, cluster epoch, the
        caller's own fence status, and any cluster health verdict)."""
        self._elastic_armed = True
        with self._barrier_cv:
            with self._member_lock:
                self._sweep_locked()
                self._bind_locked(rank, client_id)
                if rank is not None and epoch is not None and \
                        client_id not in self._fenced:
                    self._rank_epochs[rank] = int(epoch)
                view = self._topology_locked()
                # the caller's seat belongs to ANOTHER client admitted
                # after an eviction (fence nonzero): a respawned
                # original probing before it starts pushing learns it
                # must not double-write this rank
                owner = self._members.get(rank)
                view['seat_taken'] = bool(
                    rank is not None and owner is not None
                    and owner != client_id
                    and self._rank_fence.get(rank, 0) > 0)
        view['fenced'] = client_id in self._fenced
        view['health'] = self._health_alert
        return ('membership', view)

    def _resize(self, new_workers, expect_gen=None):
        """Commit a cluster shrink the surviving ranks agreed on: the
        expected-worker count drops, open vacancies close (a joiner
        arriving after the shrink is told no-vacancy), and the
        generation bumps once (idempotent — followers re-sending the
        same size neither bump nor re-log).  ``expect_gen`` is the
        generation the proposer DECIDED on: when membership moved
        underneath the decision (a replacement joined the vacancy in
        the window), the commit is rejected instead of shrinking the
        fresh member out of the cluster."""
        new_workers = int(new_workers)
        if new_workers < 1:
            raise ValueError('resize to %d workers' % new_workers)
        with self._barrier_cv:
            with self._member_lock:
                if expect_gen is not None and \
                        int(expect_gen) != self._generation:
                    return ('resize-stale', self._generation,
                            self._num_workers)
                if new_workers != self._num_workers:
                    # retire the OLDEST vacancies first — exactly the
                    # delta, so a younger vacancy whose replacement
                    # hold has not elapsed stays open for its spare
                    drop = max(0, self._num_workers - new_workers)
                    for r in sorted(self._vacant,
                                    key=self._vacant.get)[:drop]:
                        del self._vacant[r]
                        self._seats.discard(r)
                    self._num_workers = max(1, len(self._seats))
                    self._generation += 1
                    self._member_events.append(
                        {'kind': 'resize', 'workers': new_workers,
                         'generation': self._generation,
                         'time': time.time()})
                    instrument.inc('kvstore.resizes')
                    instrument.decision(
                        'kvserver', 'resize', severity='warn',
                        reason='cluster resized to %d worker(s) at '
                               'generation %d'
                               % (self._num_workers, self._generation),
                        workers=self._num_workers,
                        generation=self._generation)
                    logging.warning(
                        'kv server: cluster resized to %d worker(s) at '
                        'generation %d (seats %s)', self._num_workers,
                        self._generation, sorted(self._seats))
                    self._barrier_cv.notify_all()
                    if self._backing:
                        self._persist()
                return ('ok', self._generation, self._num_workers)

    def _ckpt_vote(self, rank, epochs):
        """Record one rank's loadable-checkpoint epochs and return all
        votes + the currently-live rank set: the cross-rank consensus
        behind ``model.consensus_latest_checkpoint`` (a rank that died
        mid-save must not make peers resume from an epoch it never
        committed)."""
        with self._barrier_cv:
            with self._member_lock:
                self._sweep_locked()
                if rank is not None:
                    self._ckpt_votes[int(rank)] = sorted(
                        {int(e) for e in (epochs or ())})
                dead = set(self._dead_ranks(
                    config.get('MXTPU_KV_DEAD_TIMEOUT')))
                gone = dead | set(self._vacant)
                # live SEATS, not range(num_workers): after a shrink
                # the surviving rank ids need not be compact, and a
                # retired seat's stale ballot must not gate (or stall)
                # the consensus
                live = [r for r in sorted(self._seats)
                        if r not in gone]
                return ('ckpt_votes', dict(self._ckpt_votes), live)

    def _persist(self):
        """Atomic commit of store + watermarks (resilience.atomic_replace:
        a kill -9 at any instant leaves the previous commit intact)."""
        with self._commit_lock:
            self._gc_clients()
            with self._store_lock:
                state = {'store': dict(self._store),
                         'acked': dict(self._acked),
                         'acked_gaps': {k: sorted(v) for k, v in
                                        self._acked_gaps.items() if v},
                         # barrier idempotency counters must survive a
                         # restart too: a worker whose barrier-N reply
                         # was lost re-sends it, and a restored server
                         # must ack the duplicate, not re-register it
                         'barrier_done': dict(self._barrier_done),
                         'applied': self._applied,
                         'generation': self._generation,
                         'rank_fence': dict(self._rank_fence),
                         'fenced': sorted(self._fenced),
                         'fenced_seats': dict(self._fenced_seats),
                         'vacant': dict(self._vacant),
                         'seats': sorted(self._seats),
                         'num_workers': self._num_workers,
                         'optimizer': self._optimizer_bytes}
            with resilience.atomic_replace(self._backing) as tmp:
                with open(tmp, 'wb') as f:
                    pickle.dump(state, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            instrument.inc('kvstore.server_commits')

    # -- server internals --------------------------------------------------
    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop:      # raced stop(): close() may not have
                _hard_close(conn)   # interrupted the blocking accept
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            # register BEFORE start so _serve's exit-time pruning always
            # finds its own entries (reconnecting clients would
            # otherwise accumulate dead sockets/threads without bound)
            self._conns.append(conn)
            self._threads.append(t)
            t.start()

    def _key_lock(self, key):
        with self._store_lock:
            if key not in self._locks:
                self._locks[key] = threading.Lock()
            return self._locks[key]

    def _client_lock(self, client_id):
        with self._store_lock:
            if client_id not in self._client_locks:
                self._client_locks[client_id] = threading.Lock()
            return self._client_locks[client_id]

    def _serve(self, conn):
        try:
            self._serve_conn(conn)
        finally:
            _hard_close(conn)
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            try:
                self._threads.remove(threading.current_thread())
            except ValueError:
                pass
            cid = self._conn_ids.pop(id(conn), None)
            # only mark gone when NO live connection still maps to this
            # client: a reconnected client's OLD serve thread may unwind
            # long after the new hello (e.g. once a parked barrier
            # releases), and marking the live client gone would let
            # _gc_clients delete its dedup watermark mid-session
            if cid is not None and cid not in self._conn_ids.values():
                self._client_gone[cid] = time.time()

    def _serve_conn(self, conn):
        client_id = None
        try:
            while True:
                msg = _recv_frame(conn)
                if self._stop:
                    _hard_close(conn)
                    return
                op = msg[0]
                if resilience.faults_on():
                    if resilience.fault_point('server.recv', op=op) == \
                            'drop':
                        continue
                try:
                    if op == 'hello':
                        client_id = msg[1]
                        self._conn_ids[id(conn)] = client_id
                        self._client_gone.pop(client_id, None)
                        # handshake ack: lets a reconnecting client
                        # verify a live server really answered (a
                        # connect to a dead port can phantom-succeed
                        # at the TCP level on some network stacks)
                        _send_frame(conn, ('hello-ok',))
                        continue
                    if op == 'push':
                        if len(msg) == 4:
                            _, seq, key, arr = msg
                            if client_id is not None and \
                                    client_id in self._fenced:
                                # zombie original: its rank was
                                # re-assigned at a newer generation —
                                # reject instead of corrupting the
                                # replacement's training
                                instrument.inc('kvstore.fenced_rejects')
                                _send_frame(conn, (
                                    'perr', seq,
                                    'StaleGenerationError: this worker '
                                    'was evicted and its rank '
                                    're-assigned (cluster generation '
                                    '%d)' % self._generation))
                                continue
                            try:
                                self._apply_seq(client_id, seq, key, arr)
                            except (ConnectionError, EOFError, OSError):
                                # includes an injected 'sever' at
                                # server.apply: a connection failure
                                # must sever the connection (push stays
                                # pending client-side for replay), not
                                # become a perr that discards it
                                raise
                            except Exception as e:
                                _send_frame(conn, ('perr', seq, '%s: %s'
                                                   % (type(e).__name__, e)))
                            else:
                                _send_frame(conn, ('ack', seq))
                        else:           # legacy fire-and-forget push
                            _, key, arr = msg
                            self._apply(key, arr)
                        continue
                    if op == 'hb':
                        # heartbeat (fire-and-forget, like push): track
                        # liveness per worker rank (ps-lite van
                        # heartbeats, kvstore_dist.h:151-160).  A third
                        # element is the v2 telemetry piggyback — old
                        # servers never read past msg[1], new servers
                        # merge only payloads whose version tag they
                        # speak, so the extension degrades to a plain
                        # beat in either direction.  A fourth element
                        # is the v3 admission generation: a beat for a
                        # rank fenced at a NEWER generation is a zombie
                        # original's — ignored, so it cannot resurrect
                        # the evicted member under its replacement.
                        rank = msg[1]
                        gen = msg[3] if len(msg) > 3 else None
                        if gen is not None and \
                                gen < self._rank_fence.get(rank, 0):
                            instrument.inc('kvstore.fenced_beats')
                            continue
                        self._last_seen[rank] = time.time()
                        if len(msg) > 2 and msg[2] is not None:
                            self._merge_telemetry(rank, msg[2])
                        continue
                    if op == 'rpc':
                        _, nonce, inner = msg
                        try:
                            reply = self._dispatch(conn, client_id, inner)
                        except (ConnectionError, EOFError, OSError):
                            raise
                        except Exception as e:
                            reply = ('err', '%s: %s'
                                     % (type(e).__name__, e))
                        _send_frame(conn, ('rpcr', nonce, reply))
                        if inner[0] == 'shutdown':
                            self.stop()
                            return
                        continue
                    # legacy v1 plain rpc (wire compat): reply unwrapped,
                    # drop the connection on a handler error so the old
                    # client fails fast instead of hanging
                    try:
                        reply = self._dispatch(conn, client_id, msg)
                    except (ConnectionError, EOFError, OSError):
                        raise
                    except Exception as e:
                        try:
                            _send_frame(conn, ('err', '%s: %s'
                                               % (type(e).__name__, e)))
                        except OSError:
                            pass
                        conn.close()
                        return
                    if reply is not None:
                        _send_frame(conn, reply)
                    if op == 'shutdown':
                        self.stop()
                        return
                except (ConnectionError, EOFError, OSError):
                    raise
        except (ConnectionError, EOFError, OSError):
            return

    def _dispatch(self, conn, client_id, msg):
        """Handle one request/response op; the returned tuple is the
        reply (wrapped or not by the caller per wire version)."""
        op = msg[0]
        if client_id is not None and client_id in self._fenced and \
                op in ('pull', 'init', 'set_optimizer', 'barrier',
                       'resize', 'ckpt_vote'):
            # data-plane AND membership-WRITE ops from a fenced zombie
            # fail fast with the typed stale-generation error (a zombie
            # shrinking the live cluster or clobbering its
            # replacement's checkpoint ballot is exactly the corruption
            # fencing exists to stop; join/membership stay open so a
            # transiently-evicted worker can discover its state and
            # reclaim its still-vacant seat)
            instrument.inc('kvstore.fenced_rejects')
            raise StaleGenerationError(
                'this worker was evicted and its rank re-assigned '
                '(cluster generation %d) — op %r refused'
                % (self._generation, op))
        if op == 'join':
            return self._join(msg[1] if len(msg) > 1 and msg[1]
                              else client_id)
        if op == 'membership':
            return self._membership(client_id,
                                    msg[1] if len(msg) > 1 else None,
                                    msg[2] if len(msg) > 2 else None)
        if op == 'resize':
            return self._resize(msg[1],
                                msg[2] if len(msg) > 2 else None)
        if op == 'ckpt_vote':
            return self._ckpt_vote(msg[1] if len(msg) > 1 else None,
                                   msg[2] if len(msg) > 2 else ())
        if op == 'pull':
            _, key = msg
            with self._key_lock(key):
                val = np.array(self._store[key], copy=True)
            return ('val', key, val)
        if op == 'init':
            _, key, arr = msg
            with self._key_lock(key):
                # first init wins (reference: worker 0 inits)
                if key not in self._store:
                    self._store[key] = np.array(arr, copy=True)
            if self._backing:
                self._persist()
            return ('ok',)
        if op == 'set_optimizer':
            from . import optimizer as opt
            self._optimizer_bytes = msg[1]
            self._updater = opt.get_updater(pickle.loads(msg[1]))
            if self._backing:
                self._persist()
            return ('ok',)
        if op == 'barrier':
            waiter = msg[1] if len(msg) > 1 else ('conn', id(conn))
            bcount = msg[2] if len(msg) > 2 else None
            rank = msg[3] if len(msg) > 3 else None
            self._barrier_wait(waiter, bcount, rank)
            return ('ok',)
        if op == 'ping':
            return ('pong',)
        if op == 'telemetry':
            return ('telemetry', self.telemetry_view())
        if op == 'dead':
            _, timeout_s = msg
            dead = self._dead_ranks(timeout_s)
            return ('dead', len(dead), dead)
        if op == 'stats':
            return ('stats', self._applied)
        if op == 'shutdown':
            return ('ok',)
        raise ValueError('unknown op %r' % (op,))

    def _apply_seq(self, client_id, seq, key, arr):
        """Apply a sequence-numbered push exactly once: replayed
        duplicates at or below the client's watermark are skipped (the
        replay path after a reconnect/restart re-sends everything
        un-acked).  Apply + watermark advance are atomic per client so a
        replay racing the original connection's backlog cannot double-
        apply."""
        if client_id is None:
            self._apply(key, arr)
            return
        with self._client_lock(client_id):
            if self._backing:
                # apply + window advance + commit atomically w.r.t. the
                # snapshot; other backed clients serialize here anyway
                # on the per-push persist
                with self._commit_lock:
                    self._apply_seq_locked(client_id, seq, key, arr)
            else:
                self._apply_seq_locked(client_id, seq, key, arr)

    def _apply_seq_locked(self, client_id, seq, key, arr):
        wm = self._acked.get(client_id, 0)
        gaps = self._acked_gaps.setdefault(client_id, set())
        if seq <= wm or seq in gaps:
            instrument.inc('kvstore.server_dup_pushes')
            return
        self._apply(key, arr)
        gaps.add(seq)
        while wm + 1 in gaps:       # advance the contiguous front
            wm += 1
            gaps.discard(wm)
        self._acked[client_id] = wm
        if self._backing and self._applied % self._sync_every == 0:
            self._persist()

    def _apply(self, key, arr):
        """Apply-on-arrival: the updater runs NOW, under this key's lock
        only (kvstore_dist_server.h:199-207), on CPU tensors made from
        the stored array and the pushed one."""
        if resilience.faults_on():
            resilience.fault_point('server.apply')
        with self._key_lock(key):
            if key not in self._store:
                raise KeyError('push before init of key %r' % (key,))
            if self._updater is None:
                self._store[key] = np.array(arr, copy=True)
            else:
                from .ndarray import NDArray
                import torch
                weight = NDArray(torch.from_numpy(
                    np.array(self._store[key], copy=True)))
                grad = NDArray(torch.from_numpy(np.array(arr, copy=True)))
                self._updater(key, grad, weight)
                self._store[key] = weight.asnumpy()
            self._applied += 1

    def _dead_ranks(self, timeout_s):
        now = time.time()
        return [r for r, t in self._last_seen.items() if now - t > timeout_s]

    # -- cluster telemetry -------------------------------------------------
    def _merge_telemetry(self, rank, payload):
        """Merge one heartbeat's metrics delta into the rank's registry
        view.  Payloads are versioned — an unknown tag is counted and
        ignored, never an error (forward compatibility mirrors the
        backward story: frames survive version skew in both directions)."""
        if (not isinstance(payload, tuple) or len(payload) != 2
                or payload[0] != 'mv2' or not isinstance(payload[1], dict)):
            instrument.inc('kvstore.telemetry_ignored')
            return
        delta = payload[1]
        with self._telemetry_lock:
            reg = self._telemetry.setdefault(
                rank, {'counters': {}, 'gauges': {}, 'timers': {},
                       'histograms': {}})
            reg.setdefault('histograms', {})   # pre-histogram restores
            prev_nan = reg['counters'].get('health.nan_steps', 0)
            for section in ('counters', 'gauges', 'timers', 'histograms'):
                part = delta.get(section)
                if isinstance(part, dict):
                    reg[section].update(part)
            reg['updated'] = time.time()
            # health-plane actuation (docs/resilience.md): a rank whose
            # sentinels saw NEW bad steps under a skip_update/abort
            # action raises a cluster-wide verdict — every rank's
            # elastic coordinator picks it up from the membership poll
            # and flight-records (abort additionally raises a clean
            # coordinated TrainingDivergedError everywhere, not a hang)
            try:
                new_nan = reg['counters'].get('health.nan_steps', 0)
                level = int(reg['gauges'].get('health.action_level', 0))
            except (TypeError, ValueError):
                new_nan, level = prev_nan, 0
            if new_nan > prev_nan and level >= 1:
                self._health_alert_seq += 1
                self._health_alert = {
                    'id': self._health_alert_seq,
                    'action': 'abort' if level >= 2 else 'skip',
                    'rank': rank,
                    'nan_steps': new_nan,
                    'generation': self._generation,
                    'time': time.time()}
                instrument.inc('kvstore.health_alerts')
        instrument.inc('kvstore.telemetry_merges')
        self._maybe_write_status()

    def telemetry_view(self):
        """The merged cluster view: per-rank registries (absolute
        values — deltas carry absolutes for changed keys) plus
        cluster-summed counters, the currently-dead ranks, and the
        cross-rank straggler attribution (``cluster.step_skew`` gauge +
        slowest-rank record) derived from the per-rank
        ``comm.step_time`` histograms the MXTPU_COMMWATCH piggyback
        delivered."""
        with self._telemetry_lock:
            ranks = {r: {'counters': dict(d['counters']),
                         'gauges': dict(d['gauges']),
                         'timers': dict(d['timers']),
                         'histograms': dict(d.get('histograms') or {}),
                         'updated': d.get('updated', 0.0)}
                     for r, d in self._telemetry.items()}
        cluster: Dict[str, float] = {}
        for d in ranks.values():
            for k, v in d['counters'].items():
                try:
                    cluster[k] = cluster.get(k, 0) + v
                except TypeError:
                    pass
        skew, laggard = compute_step_skew(ranks)
        goodput, worst_fed = compute_cluster_goodput(ranks)
        cluster_gauges = {'cluster.step_skew': skew,
                          'cluster.generation': float(self._generation)}
        if worst_fed is not None:
            # published only once a rank reported: a 0.0 placeholder
            # would be indistinguishable from a fully stalled cluster
            cluster_gauges['cluster.goodput'] = goodput
        view = {'num_workers': self._num_workers,
                'ranks': ranks,
                'cluster': {'counters': cluster,
                            'gauges': cluster_gauges},
                'dead': self._dead_ranks(
                    config.get('MXTPU_KV_DEAD_TIMEOUT')),
                'updated': time.time()}
        if worst_fed is not None:
            view['cluster']['goodput'] = worst_fed
        if self._elastic_armed:
            with self._member_lock:
                view['membership'] = self._topology_locked()
            if self._health_alert is not None:
                view['membership']['health'] = self._health_alert
        if laggard is not None:
            view['cluster']['step_skew'] = laggard
            # the health plane's laggard threshold (MXTPU_SKEW_WARN_PCT):
            # log and flight-record the slow rank
            from . import health
            health.note_skew(skew, laggard)
        return view

    def _maybe_write_status(self):
        """Rewrite the local status files (throttled to ~1/s): the JSON
        cluster view plus its Prometheus text exposition — both
        committed atomically so a scraper never reads a torn file."""
        if self._status_dir is None:
            return
        now = time.time()
        if now - self._status_last < 1.0:
            return
        self._status_last = now
        try:
            os.makedirs(self._status_dir, exist_ok=True)
            view = self.telemetry_view()
            with resilience.atomic_replace(
                    os.path.join(self._status_dir,
                                 'cluster_status.json')) as tmp:
                with open(tmp, 'w') as f:
                    json.dump(view, f, default=str)
            seen: set = set()
            parts = [instrument.render_prometheus(
                {'counters': view['cluster']['counters'],
                 'gauges': view['cluster'].get('gauges') or {}},
                labels={'rank': 'cluster'}, seen_types=seen)]
            for r, snap in sorted(view['ranks'].items()):
                parts.append(instrument.render_prometheus(
                    snap, labels={'rank': str(r)}, seen_types=seen))
            with resilience.atomic_replace(
                    os.path.join(self._status_dir,
                                 'cluster_status.prom')) as tmp:
                with open(tmp, 'w') as f:
                    f.write(''.join(parts))
        except Exception:
            logging.warning('kv server: telemetry status write failed',
                            exc_info=True)

    def _barrier_wait(self, waiter, bcount, rank=None):
        """Block until every LIVE worker registered.  Ranks whose
        heartbeats went stale past MXTPU_KV_DEAD_TIMEOUT are excluded
        from the expected count, so a crashed worker degrades the
        barrier instead of hanging it; past MXTPU_KV_BARRIER_TIMEOUT the
        waiter gets an error instead of waiting forever.  ``bcount``
        (the client's barrier call number) makes a replayed barrier
        request after a reconnect idempotent: an already-released
        barrier acks immediately instead of registering into the next
        generation.  Registrations carry the worker's ``rank`` so a
        worker that died AFTER registering neither holds the barrier nor
        fills a live worker's slot (its stale entry is excluded from the
        waiter count exactly like it is from the expected count)."""
        if resilience.faults_on():
            resilience.fault_point('server.barrier')
        self._gc_clients()      # unbacked servers GC here (low rate)
        dead_after = config.get('MXTPU_KV_DEAD_TIMEOUT')
        t_end = time.monotonic() + config.get('MXTPU_KV_BARRIER_TIMEOUT')
        with self._barrier_cv:
            if bcount is not None and \
                    bcount <= self._barrier_done.get(waiter, 0):
                return          # duplicate of a released barrier
            self._barrier_waiters[waiter] = (bcount, rank)
            if self._elastic_armed and rank is not None:
                with self._member_lock:
                    self._bind_locked(rank, waiter)
            gen = self._barrier_gen
            while self._barrier_gen == gen and not self._stop:
                with self._member_lock:
                    # evictions + vacancies recomputed every pass: a
                    # replacement joining DURING this barrier raises
                    # the expected count back (the join notifies the
                    # cv), a rank dying during it lowers it
                    self._sweep_locked()
                    # gone intersected with the SEATS: a retired seat
                    # or a ghost rank's stale beat must not deflate
                    # the expected count
                    gone = (set(self._dead_ranks(dead_after)) |
                            set(self._vacant)) & self._seats
                    expected = max(1, len(self._seats) - len(gone))
                live = sum(1 for bc_rk in self._barrier_waiters.values()
                           if bc_rk[1] is None or bc_rk[1] not in gone)
                if live >= expected:
                    if expected < self._num_workers:
                        instrument.inc('kvstore.barrier_degraded')
                    for w, (bc, _rk) in self._barrier_waiters.items():
                        if bc is not None:
                            self._barrier_done[w] = max(
                                self._barrier_done.get(w, 0), bc)
                    self._barrier_waiters.clear()
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                    if self._backing:
                        # commit the release NOW: a kill before the
                        # next push-driven persist would otherwise
                        # forget these done-counters and re-register a
                        # worker's re-sent barrier as a fresh waiter
                        self._persist()
                    break
                if time.monotonic() >= t_end:
                    self._barrier_waiters.pop(waiter, None)
                    raise BarrierTimeout(
                        'barrier timed out after %.0fs (%d live of %d '
                        'expected workers)'
                        % (config.get('MXTPU_KV_BARRIER_TIMEOUT'),
                           live, expected))
                self._barrier_cv.wait(timeout=0.25)

    def stop(self):
        self._stop = True
        _hard_close(self._sock)     # shutdown unblocks a parked accept
        # close established connections too: serve threads blocked in
        # recv unblock immediately instead of lingering until process
        # exit (and stop() actually looks like a server death to
        # clients, which the chaos tests rely on)
        for conn in list(self._conns):
            _hard_close(conn)
        with self._barrier_cv:
            self._barrier_cv.notify_all()
        # and wait for them (bounded): a serve thread that has run the port's
        # updater and is still alive when the process exits can abort
        # the exit ("terminate called without an active exception", about
        # 1 exit in 7 on the CPU); the reference leaves them to die with
        # the process
        t_end = time.monotonic() + 5.0
        me = threading.current_thread()
        for t in [self._accept_thread] + list(self._threads):
            if t is not me and t.is_alive():
                t.join(timeout=max(0.0, t_end - time.monotonic()))

    @property
    def applied_pushes(self):
        return self._applied


class AsyncKVClient(object):
    """Worker side.  ``push`` enqueues and returns immediately (the
    non-blocking contract of async mode); a dedicated sender thread owns
    the socket writes so per-worker ordering is preserved.  ``pull``
    flushes the queue implicitly (same socket) and blocks for the reply.

    Reliability: every push carries a sequence number and is kept in a
    pending buffer until the server acks it; on a connection loss the
    client redials with exponential backoff (``RetryPolicy``) and
    replays everything pending, and RPCs re-send after a per-attempt
    timeout until the per-op deadline — so a server restart is invisible
    to the training loop short of added latency.  If the server stays
    unreachable past MXTPU_KV_RECONNECT_DEADLINE the client turns every
    subsequent op into an immediate ``ConnectionError`` instead of
    hanging."""

    def __init__(self, addr, timeout=60.0, retry=None, client_id=None):
        host, port = addr.rsplit(':', 1)
        self._addr = (host, int(port))
        self._retry = (retry if retry is not None
                       else resilience.RetryPolicy.from_env())
        self._client_id = client_id or uuid.uuid4().hex
        self._closed = False
        self._suppress_reconnect = False
        self._dead_err: Optional[BaseException] = None
        self._push_err: Optional[BaseException] = None
        self._send_err: Optional[BaseException] = None
        self._seq = 0               # last assigned push sequence number
        self._bseq = 0              # barrier call counter
        self._rank = None           # learned from start_heartbeat(rank)
        self._gen = 0               # admission generation (v3 beats)
        self._tm_last = {}          # last telemetry values sent per key
        self._nonce = 0             # rpc request id
        self._pending = collections.OrderedDict()   # seq -> (key, arr)
        self._pending_cv = threading.Condition()
        self._last_push_progress = time.monotonic()
        self._conn_lock = threading.RLock()
        self._conn_gen = 0
        self._sock = None
        self._connect_initial(timeout)
        self._sendq = queue.Queue()
        self._respq = queue.Queue()
        self._rpc_lock = threading.Lock()
        self._sender = threading.Thread(target=self._send_loop, daemon=True)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._sender.start()
        self._reader.start()

    # -- connection management ---------------------------------------------
    def _connect_initial(self, timeout):
        deadline = time.time() + timeout
        last_err = None
        while time.time() < deadline:
            try:
                sock = socket.create_connection(self._addr, timeout=timeout)
                break
            except OSError as e:    # server may not be up yet
                last_err = e
                time.sleep(0.05)
        else:
            raise ConnectionError('cannot reach kv server at %s:%d: %s'
                                  % (self._addr + (last_err,)))
        self._handshake(sock, timeout=timeout)
        self._sock = sock

    def _handshake(self, sock, timeout=5.0):
        """hello + verified hello-ok: proves a live kv server is on the
        other end before the connection is trusted (and before pending
        pushes are replayed into it)."""
        self._prepare_sock(sock)
        sock.settimeout(timeout)
        try:
            _send_frame(sock, ('hello', self._client_id))
            resp = _recv_frame(sock)
            if resp[0] != 'hello-ok':
                raise ConnectionError('unexpected handshake reply %r'
                                      % (resp[:1],))
        except socket.timeout:
            raise ConnectionError('kv server handshake timed out')
        finally:
            try:
                sock.settimeout(None)
            except OSError:
                pass

    @staticmethod
    def _prepare_sock(sock):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # blocking mode: create_connection's timeout would otherwise
        # also bound every later recv, killing idle connections (e.g. a
        # worker parked in a long barrier).  Deadlines live at the RPC
        # layer, and close() unblocks a wedged send/recv by closing the
        # socket out from under it.
        sock.settimeout(None)

    def _reconnect(self, gen, cause):
        """Redial + handshake + pending replay.  Returns True once the
        connection generation is past ``gen`` (this call or a concurrent
        one reconnected); False when the client is closed or the retry
        deadline expired (the client is then permanently dead)."""
        with self._conn_lock:
            if self._closed or self._suppress_reconnect:
                return False
            if self._conn_gen > gen:
                return self._dead_err is None
            if self._dead_err is not None:
                return False
            self._send_err = cause
            _hard_close(self._sock)
            t_end = time.monotonic() + \
                config.get('MXTPU_KV_RECONNECT_DEADLINE')
            attempt = 0
            while not self._closed:
                d = self._retry.delay(attempt)
                attempt += 1
                if time.monotonic() + d >= t_end:
                    break
                time.sleep(d)
                instrument.inc('kvstore.retries')
                try:
                    sock = socket.create_connection(self._addr, timeout=5.0)
                except OSError as e:
                    cause = e
                    continue
                try:
                    self._handshake(sock, timeout=max(
                        0.2, min(5.0, t_end - time.monotonic())))
                    self._replay_onto(sock)
                except OSError as e:
                    _hard_close(sock)
                    cause = e
                    continue
                self._sock = sock
                self._conn_gen += 1
                instrument.inc('kvstore.reconnects')
                return True
            self._dead_err = ConnectionError(
                'kv server %s:%d unreachable after %.0fs: %s'
                % (self._addr + (config.get('MXTPU_KV_RECONNECT_DEADLINE'),
                                 cause)))
            self._respq.put(None)       # unblock a waiting rpc
            with self._pending_cv:      # unblock backpressured pushes
                self._pending_cv.notify_all()
            return False

    def _replay_onto(self, sock):
        """Re-send every un-acked push, in order, on ``sock`` (single
        home of the replay framing + fault hook; the server's receiver
        window dedups whatever was already applied)."""
        with self._pending_cv:
            pending = list(self._pending.items())
            self._last_push_progress = time.monotonic()
        for seq, (key, arr) in pending:
            if resilience.faults_on() and \
                    resilience.fault_point('client.send',
                                           op='push') == 'drop':
                continue
            _send_frame(sock, ('push', seq, key, arr))
            instrument.inc('kvstore.push_replays')

    def _replay_pending(self):
        """Re-send every un-acked push on the current connection (used
        when acks stall — e.g. injected frame drops — while the socket
        itself stays healthy)."""
        with self._conn_lock:
            if self._dead_err is not None or self._sock is None:
                return
            try:
                self._replay_onto(self._sock)
            except OSError:
                pass        # reader/sender will notice and reconnect

    # -- io threads --------------------------------------------------------
    def _send_loop(self):
        while True:
            msg = self._sendq.get()
            if msg is None:
                return
            self._send_msg(msg)

    def _send_msg(self, msg):
        """Send one frame, reconnecting on socket failure.  Failures are
        recorded (``_send_err``) and surfaced by the next RPC / close()
        rather than swallowed; a failed sequence-numbered push is NOT
        re-sent here — the reconnect replays the whole pending buffer,
        which includes it."""
        while True:
            with self._conn_lock:
                gen = self._conn_gen
            try:
                if resilience.faults_on():
                    if resilience.fault_point('client.send', op=msg[0]) \
                            == 'drop':
                        return
                with self._conn_lock:
                    _send_frame(self._sock, msg)
                return
            except OSError as e:
                self._send_err = e
                instrument.inc('kvstore.send_errors')
                if self._closed or not self._reconnect(gen, e):
                    return
                if msg[0] == 'push' and len(msg) == 4:
                    return      # replay already re-sent it
                # non-push frame: retry on the fresh connection

    def _read_loop(self):
        while True:
            with self._conn_lock:
                sock, gen = self._sock, self._conn_gen
            try:
                frame = _recv_frame(sock)
            except (ConnectionError, OSError, EOFError) as e:
                if self._closed or not self._reconnect(gen, e):
                    self._respq.put(None)
                    return
                continue
            if resilience.faults_on():
                try:
                    if resilience.fault_point('client.recv',
                                              op=frame[0]) == 'drop':
                        continue
                except OSError as e:
                    if self._closed or not self._reconnect(gen, e):
                        self._respq.put(None)
                        return
                    continue
            self._route(frame)

    def _route(self, frame):
        op = frame[0]
        if op == 'ack':
            with self._pending_cv:
                self._pending.pop(frame[1], None)
                self._last_push_progress = time.monotonic()
                self._pending_cv.notify_all()
        elif op == 'perr':
            with self._pending_cv:
                self._pending.pop(frame[1], None)
                self._last_push_progress = time.monotonic()
                self._pending_cv.notify_all()
            if self._push_err is None:
                msg = 'kv server push error: %s' % frame[2]
                self._push_err = (
                    StaleGenerationError(msg)
                    if str(frame[2]).startswith('StaleGeneration')
                    else RuntimeError(msg))
            instrument.inc('kvstore.push_errors')
        elif op == 'rpcr':
            self._respq.put(frame)
        # anything else is a stale frame from a previous connection

    # -- rpc core ----------------------------------------------------------
    def _check_health(self, consume_push_err=True):
        if self._dead_err is not None:
            raise ConnectionError(str(self._dead_err))
        if not consume_push_err:
            return
        err, self._push_err = self._push_err, None
        if err is not None:
            raise err

    def _rpc(self, msg, deadline=None, consume_push_err=True):
        """Send a request and wait for its reply, re-sending after each
        MXTPU_KV_RPC_TIMEOUT until the per-op deadline
        (MXTPU_KV_OP_DEADLINE).  All retried ops are idempotent on the
        server (pull/init/ping/stats/dead trivially; barrier via the
        per-client barrier counter; set_optimizer by value), so a
        re-send after a lost reply is safe.

        ``consume_push_err=False`` keeps a pending push error in place
        for the DATA-plane caller it belongs to: control-plane polls
        issued from background threads (the elastic coordinator's
        membership loop) must not pop-and-swallow an error the fit
        thread is contractually owed on its next kv op."""
        self._check_health(consume_push_err)
        rpc_timeout = config.get('MXTPU_KV_RPC_TIMEOUT')
        t_end = time.monotonic() + (config.get('MXTPU_KV_OP_DEADLINE')
                                    if deadline is None else deadline)
        with self._rpc_lock:
            # stale replies of a previously timed-out rpc: drain them
            while True:
                try:
                    self._respq.get_nowait()
                except queue.Empty:
                    break
            # acks stalled (dropped frames on a healthy socket): nudge
            # the pending buffer along before adding more traffic
            with self._pending_cv:
                stalled = (self._pending and time.monotonic()
                           - self._last_push_progress > rpc_timeout)
            if stalled:
                self._replay_pending()
            self._nonce += 1
            nonce = self._nonce
            wire = ('rpc', nonce, msg)
            attempt = 0
            while True:
                self._sendq.put(wire)
                att_end = min(t_end, time.monotonic() + rpc_timeout)
                reply = None
                while time.monotonic() < att_end:
                    try:
                        resp = self._respq.get(timeout=max(
                            0.001, min(att_end - time.monotonic(), 0.5)))
                    except queue.Empty:
                        continue
                    if resp is None:
                        raise ConnectionError(
                            str(self._dead_err
                                or 'kv server connection lost'))
                    if resp[1] == nonce:
                        reply = resp[2]
                        break
                    # stale reply from an earlier attempt: discard
                if reply is not None:
                    if reply[0] == 'err':
                        if str(reply[1]).startswith('StaleGeneration'):
                            raise StaleGenerationError(
                                'kv server error: %s' % reply[1])
                        raise RuntimeError('kv server error: %s'
                                           % reply[1])
                    # a perr routed just before this reply belongs to a
                    # push that logically preceded it on the wire
                    self._check_health(consume_push_err)
                    return reply
                instrument.inc('kvstore.rpc_timeouts')
                if time.monotonic() >= t_end or self._dead_err is not None:
                    raise ConnectionError(
                        'kv rpc %r timed out after %d attempt(s); '
                        'last send error: %s'
                        % (msg[0], attempt + 1, self._send_err))
                attempt += 1
                instrument.inc('kvstore.retries')

    # -- api ---------------------------------------------------------------
    def push(self, key, arr):
        """Non-blocking: returns as soon as the frame is enqueued.  The
        push stays in the pending buffer until the server acks it
        (crash replay); when MXTPU_KV_MAX_PENDING pushes are in flight
        the call blocks for acks (bounded replay memory)."""
        self._check_health()
        arr = np.asarray(arr)
        max_pending = config.get('MXTPU_KV_MAX_PENDING')
        t_end = time.monotonic() + config.get('MXTPU_KV_OP_DEADLINE')
        with self._pending_cv:
            while len(self._pending) >= max_pending:
                if self._dead_err is not None:
                    raise ConnectionError(str(self._dead_err))
                if time.monotonic() >= t_end:
                    raise ConnectionError(
                        'push backpressure: %d un-acked pushes'
                        % len(self._pending))
                self._pending_cv.wait(timeout=0.1)
            if not self._pending:
                self._last_push_progress = time.monotonic()
            self._seq += 1
            seq = self._seq
            self._pending[seq] = (key, arr)
        self._sendq.put(('push', seq, key, arr))

    def pull(self, key):
        resp = self._rpc(('pull', key))
        assert resp[0] == 'val' and resp[1] == key
        return resp[2]

    def init(self, key, arr):
        self._rpc(('init', key, np.asarray(arr)))

    def set_optimizer_bytes(self, payload):
        self._rpc(('set_optimizer', payload))

    def flush(self, timeout=60.0):
        """Block until every pending push is acked.  The healthy path
        just waits on the ack condition variable (acks notify it) — no
        extra traffic; only when ack progress stalls past the RPC
        timeout does it ping (whose _rpc entry replays the pending
        buffer).  Returns True when drained, False on timeout."""
        t_end = time.monotonic() + timeout
        rpc_timeout = config.get('MXTPU_KV_RPC_TIMEOUT')
        while time.monotonic() < t_end:
            with self._pending_cv:
                if not self._pending:
                    return True
                stalled = (time.monotonic() - self._last_push_progress
                           > rpc_timeout)
                if not stalled:
                    self._pending_cv.wait(timeout=0.2)
                    if not self._pending:
                        return True
            if stalled:
                self._rpc(('ping',), deadline=max(
                    0.1, min(rpc_timeout, t_end - time.monotonic())))
        with self._pending_cv:
            return not self._pending

    def barrier(self, timeout=None):
        """Block until every live worker arrived.  Deadline-bounded
        (MXTPU_KV_BARRIER_TIMEOUT both here and server-side) and
        idempotent under re-send via the per-client barrier counter.

        The wait is a ``kvstore.barrier`` trace span (the shared-anchor
        event ``tools/merge_traces.py`` aligns rank clocks on: every
        rank leaves a barrier at the same real instant), the goodput
        ledger's 'barrier' bucket and, under MXTPU_COMMWATCH, the
        ``comm.barrier_wait`` histogram: the cross-rank wait-time half of
        the straggler picture (a rank that computes slowly makes its
        PEERS wait here)."""
        self._bseq += 1
        t0 = time.monotonic()
        from . import iowatch
        with instrument.span('kvstore.barrier', cat='kvstore'), \
                iowatch.account('barrier'):
            self._rpc(('barrier', self._client_id, self._bseq,
                       self._rank),
                      deadline=(config.get('MXTPU_KV_BARRIER_TIMEOUT')
                                if timeout is None else timeout))
        from . import commwatch
        commwatch.barrier_wait(time.monotonic() - t0)

    def stats(self):
        return self._rpc(('stats',))[1]

    def ping(self, timeout=None):
        """Protocol handshake — used to verify the listener on a
        launcher-provided address really is a kv server."""
        resp = self._rpc(('ping',), deadline=timeout)
        if resp[0] != 'pong':
            raise ConnectionError('not a kv server')

    def _telemetry_delta(self):
        """Changed instrument metrics since the last sent beat, or None
        when nothing changed (the beat then stays a bare 2-tuple).
        Values are absolutes — the server's merge is a plain overwrite,
        so replays are idempotent; beats only vanish when the
        connection dies, and the redial resets ``_tm_last`` so the next
        beat re-carries the FULL registry (a restarted server rebuilds
        its per-rank view from scratch)."""
        snap = instrument.metrics_snapshot()
        delta = {}
        # histograms ride too (their snapshot dicts compare by value,
        # so an unchanged histogram costs nothing on the wire); old
        # servers merge only the sections they know and structurally
        # ignore the extra key — same skew story as the mv2 tag itself
        for section in ('counters', 'gauges', 'timers', 'histograms'):
            cur = snap.get(section) or {}
            changed = {k: v for k, v in cur.items()
                       if self._tm_last.get((section, k)) != v}
            if changed:
                delta[section] = changed
                for k, v in changed.items():
                    self._tm_last[(section, k)] = v
        return delta or None

    def start_heartbeat(self, rank, interval=1.0):
        """Periodic liveness beacon; the server marks ranks dead when
        beats stop (the ps-lite van heartbeat).  Beats travel on their
        OWN connection — the data socket's serve thread parks inside
        blocking ops like barrier, so beats sharing it would queue
        unread and a worker legitimately waiting in a long barrier
        would read as dead.

        With the metrics registry on (and MXTPU_TELEMETRY not disabled)
        each beat piggybacks the compact telemetry delta — the
        cluster-aggregation carrier of docs/observability.md: no extra
        connection, no extra RPC, and a dead rank's final state is
        whatever its last beat delivered."""
        self._rank = rank
        self._hb_stop = threading.Event()
        self._tm_last = {}

        def beat():
            sock = None
            while not self._hb_stop.is_set():
                if sock is None:
                    try:
                        sock = socket.create_connection(self._addr,
                                                        timeout=5.0)
                        sock.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        # fresh connection (first, or a restarted
                        # server that rebuilt its view empty — and a
                        # delta marked sent may have died with the old
                        # socket): resend the FULL registry next beat
                        self._tm_last = {}
                    except OSError:
                        sock = None
                        if self._hb_stop.wait(min(interval, 1.0)):
                            break
                        continue
                delta = None
                if instrument.metrics_enabled() and \
                        config.get('MXTPU_TELEMETRY'):
                    try:
                        delta = self._telemetry_delta()
                    except Exception:
                        delta = None   # telemetry must never kill beats
                # v3 frame: the admission generation rides every beat
                # so a zombie's heartbeats cannot resurrect a rank that
                # was re-assigned (old servers index msg[1] only and
                # treat msg[2] is None as no-telemetry — both extras
                # degrade structurally).
                frame = ('hb', self._rank,
                         ('mv2', delta) if delta is not None else None,
                         self._gen)
                try:
                    _send_frame(sock, frame)
                except OSError:
                    _hard_close(sock)   # server restart: redial
                    sock = None
                    continue
                if self._hb_stop.wait(interval):
                    break
            if sock is not None:
                _hard_close(sock)

        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        if getattr(self, '_hb_stop', None) is not None:
            self._hb_stop.set()

    def num_dead_nodes(self, timeout_s=5.0):
        resp = self._rpc(('dead', float(timeout_s)))
        return resp[1]

    def telemetry(self):
        """The server's merged cluster telemetry view (per-rank metric
        registries + cluster-summed counters + dead ranks)."""
        resp = self._rpc(('telemetry',))
        assert resp[0] == 'telemetry'
        return resp[1]

    def shutdown_server(self):
        self._suppress_reconnect = True
        try:
            self._rpc(('shutdown',), deadline=10.0)
        except ConnectionError:
            pass

    @property
    def pending_pushes(self):
        with self._pending_cv:
            return len(self._pending)

    @property
    def last_send_error(self):
        return self._send_err

    def close(self, timeout=30.0):
        """Drain pending pushes (wait for acks, replaying once if they
        stall), then stop the io threads and close the socket.  Bounded:
        a hung or dead peer cannot wedge interpreter exit — after
        ``timeout`` the remaining pushes are reported as lost (warning +
        ``kvstore.lost_pushes``) and the socket is closed regardless.
        Returns the number of undelivered pushes (0 on a clean close)."""
        if self._closed:
            return 0
        self.stop_heartbeat()   # a closed client must read as dead —
        # a still-beating ghost would defeat dead-rank barrier exclusion
        t_end = time.monotonic() + timeout
        replay_at = time.monotonic() + min(
            config.get('MXTPU_KV_RPC_TIMEOUT'), max(timeout / 3.0, 0.1))
        replayed = False
        while self._dead_err is None and time.monotonic() < t_end:
            with self._pending_cv:
                if not self._pending:
                    break
                self._pending_cv.wait(timeout=0.1)
                drained = not self._pending
            if drained:
                break
            if not replayed and time.monotonic() >= replay_at:
                replayed = True
                self._replay_pending()
        with self._pending_cv:
            undelivered = len(self._pending)
        self._closed = True
        self._suppress_reconnect = True
        self._sendq.put(None)
        self._sender.join(timeout=max(0.1, t_end - time.monotonic()))
        _hard_close(self._sock)     # unblocks a wedged send/recv
        if undelivered:
            instrument.inc('kvstore.lost_pushes', undelivered)
            logging.warning(
                'kv client closed with %d undelivered push(es); '
                'last send error: %s', undelivered,
                self._send_err or self._dead_err)
        return undelivered


def server_addr_from_env():
    """Resolve the server address the launcher published
    (``MXTPU_KV_SERVER_ADDR``; falls back to the coordinator host on
    port+1, the ps-lite DMLC_PS_ROOT_URI convention)."""
    addr = config.get('MXTPU_KV_SERVER_ADDR')
    if addr:
        return addr
    coord = config.get('MXTPU_COORDINATOR')
    if coord:
        host, port = coord.rsplit(':', 1)
        return '%s:%d' % (host, int(port) + 1)
    return None
