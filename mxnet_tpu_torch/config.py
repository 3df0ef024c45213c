"""Runtime environment-variable config registry.

The port's trimmed copy of ``mxnet_tpu/config.py``: only the knobs this
package reads, under the SAME names, so one deployment environment
configures both packages alike.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple


class _Knob(NamedTuple):
    name: str
    default: object
    parse: Callable
    doc: str


def _bool(v):
    return str(v).lower() in ('1', 'true', 'yes', 'on')


_REGISTRY: Dict[str, _Knob] = {}


def _register(name, default, parse, doc):
    _REGISTRY[name] = _Knob(name, default, parse, doc)


# -- engine ----------------------------------------------------------------
_register('MXNET_ENGINE_TYPE', 'ThreadedEnginePerDevice', str,
          'Execution mode: NaiveEngine = every step runs eagerly, op by '
          'op (no CUDA graph capture); anything else captures each fit '
          'step, LM train step and served bucket forward once per batch '
          'signature and replays it (env_var.md:8). Consumed at import '
          'by engine.set_engine_type.')
_register('MXNET_CPU_WORKER_NTHREADS', os.cpu_count() or 4, int,
          'Worker threads of the host-side dependency engine '
          '(env_var.md:10; engine.NativeEngine, csrc/host/engine.cc), '
          'which runs PrefetchingIter\'s fetches.')
# -- backward mirroring (executor.mirror_wrap) -------------------------------
_register('MXNET_BACKWARD_DO_MIRROR', False, _bool,
          'Trade compute for memory in backward (env_var.md:56-60; '
          'graph_executor.cc:199-216 mirror pass).  Every differentiated '
          'forward (the executor\'s, the fused train step\'s, the '
          'sequence-parallel step\'s) runs under non-reentrant '
          'torch.utils.checkpoint, which recomputes activations during '
          'backward instead of keeping them in device memory.  '
          'MXNET_BACKWARD_MIRROR_POLICY picks what is kept.')
_register('MXNET_BACKWARD_MIRROR_POLICY', 'dots', str,
          "Remat policy under MXNET_BACKWARD_DO_MIRROR: 'dots' keeps "
          "matmul/conv outputs and recomputes cheap elementwise ops "
          "(closest to the reference mirror, which re-runs activation/"
          "BN-type nodes); 'nothing' rematerializes everything "
          "(the most memory saved, the forward run twice).")
# -- fit: fused step, checkpoints --------------------------------------------
_register('MXTPU_FUSED_FIT', True, _bool,
          'Module.fit runs forward, backward and every update as one fused '
          'step (captured on the card) when the optimizer has a functional '
          'form.  Set 0 for the reference-style per-parameter Updater loop '
          '(forward_backward, then the ops/optim.py update ops).')
_register('MXTPU_AUTO_RESUME', False, _bool,
          'fit(checkpoint_prefix=...) resumes from the newest loadable '
          'checkpoint above begin_epoch (model.find_latest_checkpoint; a '
          'truncated file is skipped).  Same as fit(auto_resume=True).')
# -- sync-free fit loop ------------------------------------------------------
_register('MXTPU_ASYNC_DEPTH', 2, int,
          'Max in-flight training steps in the fit loop '
          '(engine.StepWindow): step N+1 is launched while step N runs '
          'on the device, with backpressure on the oldest step. '
          '1 = fully synchronous stepping.')
_register('MXTPU_DEVICE_FEED', True, _bool,
          'Double-buffered host->device feed: Module.fit wraps the '
          'train iterator in io.DeviceFeedIter, which stages batch N+1 '
          'through pinned memory onto the device on its own stream, '
          'from a background thread, while step N runs.  Set 0 to copy '
          'batch data on the step\'s critical path.')
# -- step compiler (fuse.py) ------------------------------------------------
_register('MXTPU_FUSE', '', str,
          "Pass pipeline mode (fuse.py PassManager) for every symbol the "
          "Executor runs: 'off' = no rewrites; 'safe' = structural "
          "passes only (constant folding, dead-branch pruning, "
          "elementwise-epilogue replay); 'aggressive' = adds conv+BN "
          'weight folding and the BN->relu kernel fusion.  Unset: '
          'MXTPU_FUSE_BN_CONV set -> aggressive, else off.')
_register('MXTPU_FUSE_SKIP', '', str,
          'Comma-separated pass names (fuse.default_passes) excluded '
          'from the MXTPU_FUSE pipeline.')
_register('MXTPU_FUSE_BN_CONV', False, _bool,
          'Legacy alias: equivalent to MXTPU_FUSE=aggressive when '
          'MXTPU_FUSE is unset.')
# -- fit warm start (module/, compile_cache.py) ----------------------------
_register('MXTPU_WARM_START', False, _bool,
          'Module.fit builds the fused train step BEFORE the first batch: '
          'the fuse passes, shape inference, the graph function and the '
          'kernel libraries it will launch, and on the card captures the '
          'step for the bound batch signature (a warm-up step whose '
          'effects are undone), so the first batch pays none of that.  '
          'Same as fit(warm_start=True).')
_register('MXTPU_COMPILE_CACHE', '', str,
          'Directory of the persistent compile cache and the warmup '
          'manifest (compile_cache.py).  What persists are the NVRTC '
          'cubins of mx.rtc.Rtc (<dir>/rtc/, keyed by source, kernel '
          'name, compute capability and NVRTC version: a later process '
          'loads them instead of compiling, compile.cache_hits) and the '
          'batch signatures of every captured step (<dir>/manifest.json: '
          'fit_step entries a warm start captures again before the '
          'first batch, and each signature\'s counted '
          'FLOPs).  A CUDA graph itself cannot be saved: a warm process '
          'still records its graphs, off the hot path.  The nvcc kernel '
          'libraries persist in build/mxnet_tpu_torch/ regardless.  '
          'Unset: no directory, no file.')
_register('MXTPU_PRECOMPILE_BUCKETS', False, _bool,
          'BucketingModule binds, warms and (on the card) captures every '
          'bucket declared via bucket_keys=[...] at fit start instead of '
          'binding each bucket lazily the first time its key appears '
          'mid-epoch.')
# -- dp x tp sharded fit (parallel/mesh.py) ---------------------------------
_register('MXTPU_MESH', '', str,
          "Device mesh for Module.fit: '4x2' / 'dp=4,tp=2' / '8'.  One "
          'process per mesh position (tools/launch.py or '
          'torch.multiprocessing.spawn; dp*tp ranks, rank (d, t) = d*tp + '
          't): the batch is split over dp, parameters placed per '
          'MXTPU_PARTITION, optimizer state ZeRO-sharded over dp '
          '(parallel/zero.py), BatchNorm over the global batch.  The '
          "collectives run inside each rank's step; a dist kvstore is "
          'demoted to control-plane duties.  Same as fit(mesh=...).  '
          "'1x1' needs no process group.  Unset: the unmeshed fit.")
_register('MXTPU_PARTITION', '', str,
          "Parameter partition policy under MXTPU_MESH: 'replicated' "
          "(default, pure data parallelism) or 'auto' (each parameter's "
          'storage and optimizer state sharded over the tp axis along its '
          'largest tp-divisible dim; indivisible tensors stay replicated).  '
          'fit(partition=...) also takes a {name-substring: spec} dict.')
# -- serving (serving/batcher.py, serving/server.py) -----------------------
_register('MXTPU_SERVE_MAX_DELAY_MS', 2.0, float,
          'Dynamic-batching flush deadline (milliseconds): a queued '
          'request waits at most this long for more requests to '
          'coalesce before a partial batch is flushed.')
_register('MXTPU_SERVE_MAX_BATCH', 64, int,
          'Cap on coalesced rows per serving flush (also the largest '
          'pow2 bucket the batcher fills).  A single larger request '
          'still executes, alone.')
_register('MXTPU_SERVE_MAX_QUEUE', 1024, int,
          'Admission bound on queued requests per model: past it '
          'submit() sheds with ServerOverloadedError.')
_register('MXTPU_SERVE_REQUEST_TIMEOUT', 30.0, float,
          'Seconds a blocking ModelServer.predict() waits for its '
          'response before raising TimeoutError.')
_register('MXTPU_SERVE_DRAIN_TIMEOUT', 30.0, float,
          'Bound (seconds) on serving drains: unload_model(drain=True), '
          'close() and ModelServer.drain() stop waiting on worker joins '
          'past it and fail what is left (queued, and in flight on a '
          'wedged replica) with typed errors instead of hanging.')
_register('MXTPU_SERVE_REPLICAS', 1, int,
          'Default replica count per loaded model (load_model replicas= '
          'overrides): N replicas, each its own Predictor (own graphs, '
          'own graph memory pool, own parameter copy) on its own CUDA '
          'stream, serve one shared admission queue, one coalescing '
          'worker each.  Replica slot s runs on device (dev_id + s) mod '
          'the device count: on one card every replica shares it.')
_register('MXTPU_SERVE_DEADLINE_MS', 0.0, float,
          'Default per-request deadline (milliseconds) for '
          'ModelServer.submit(): a request still queued past it is '
          'dropped at coalesce time, never executed, and fails with '
          'DeadlineExceededError (serving.deadline_drops; kept out of '
          'the latency histograms).  0 = no deadline; per-call '
          'deadline_ms= overrides.')
_register('MXTPU_SERVE_SUPERVISE', False, _bool,
          'Enable replica supervision (serving/supervisor.py) for every '
          'loaded model: a worker wedged past MXTPU_SERVE_WEDGE_MS, or '
          'dead on an exception, is quarantined, its in-flight requests '
          're-queued once at the head of their lane, and a warmed '
          '(captured) replacement attached before the quarantined one is '
          'torn down.  Off: no supervision thread.')
_register('MXTPU_SERVE_WEDGE_MS', 5000.0, float,
          'No-progress threshold (milliseconds) for replica supervision: '
          'a flush in flight this long is declared wedged.  Keep it well '
          'above the slowest legitimate flush.')
_register('MXTPU_SERVE_SUPERVISE_INTERVAL', 0.2, float,
          'Supervisor poll period (seconds).  <= 0: no poll thread '
          '(tick() can still be driven by hand).')
_register('MXTPU_SERVE_SLO_MS', 0.0, float,
          'Serving p99 latency SLO (milliseconds) the replica autoscaler '
          'holds (ModelServer.autoscale default; 0 = no default, '
          'autoscale() then needs an explicit slo_p99_ms).  The '
          'autoscaler reads WINDOWED p99 (instrument.HistogramWindow '
          'deltas of the serving histograms), never lifetime aggregates.')
_register('MXTPU_SERVE_MAX_REPLICAS', 4, int,
          'Autoscaler ceiling on replicas per model.  At the ceiling the '
          'controller shrinks the max batch (or, with brownout, climbs '
          'its ladder) instead of adding replicas.')
_register('MXTPU_SERVE_SCALE_INTERVAL', 1.0, float,
          'Autoscaler control-loop period (seconds): each tick reads one '
          'windowed p99 / queue / shed sample per watched model and '
          'applies at most one hysteresis-gated decision (every decision '
          'logged as an event).  <= 0: no control thread (tick() can '
          'still be driven by hand).')
_register('MXTPU_SERVE_BROWNOUT', False, _bool,
          "Default for the autoscaler's graceful-brownout ladder "
          '(watch(brownout=...)): under sustained breach AT capacity the '
          'fleet degrades in order (shed the batch lane, shrink '
          'max_batch, serve the smallest bucket) before interactive '
          'traffic is ever shed; each rung is a logged, hysteresis-gated '
          'decision (serving.brownout_level gauge).')
_register('MXTPU_SERVEWATCH', False, _bool,
          'Enable the request-attribution plane (serving/servewatch.py): '
          'every admitted request gets a request id and an exclusive-'
          'bucket span chain (admission_wait / lane_wait / coalesce_wait '
          '/ pad / execute / slice_deliver summing to e2e exactly) '
          'recorded as serving.req.* histograms, flush composition '
          'records, latency-histogram exemplars (request id per le= '
          'bucket, in the Prometheus exposition too) and tail '
          'postmortems (MXTPU_SERVE_TRACE_SLOW_MS).  Implies metrics; '
          'spawns no threads.  Off: every hook is a single flag check.')
_register('MXTPU_SERVE_TRACE_SLOW_MS', 0.0, float,
          'Tail-forensics threshold (milliseconds): under '
          'MXTPU_SERVEWATCH, a request whose e2e latency breaches it (or '
          'that is shed, errored, replayed or deadline-dropped) commits '
          'a durable flight-record postmortem naming its span chain, the '
          'flush it rode, the queue depths at admission and the '
          'autoscaler decisions inside its window (needs '
          'MXTPU_FLIGHT_RECORDER).  0 = only sheds/errors/replays/'
          'deadline drops commit postmortems.')
_register('MXTPU_SERVE_POSTMORTEM_CAP', 64, int,
          'Upper bound on per-request postmortems committed per process '
          '(servewatch): under sustained overload every request '
          'breaches, and unbounded dumps would become their own tail '
          'source.  Past the cap serving.postmortems_dropped counts '
          'what was suppressed.')
# -- observability (instrument.py, health.py) --------------------------------
_register('MXTPU_PROFILE', False, _bool,
          'Enable the instrument.py span tracer (Chrome-trace spans: the '
          'serving flush, servewatch request chains, decision instants; '
          'dump with instrument.dump_trace).  Implies metrics.  Off: '
          'every span is a no-op.')
_register('MXTPU_METRICS', True, _bool,
          'Record the instrument.py metrics registry (counters, gauges, '
          'timers, histograms; instrument.metrics_snapshot).  On by '
          'default in the port (the reference defaults to off): the '
          'launch and capture counters of a card run are always wanted.  '
          '0 turns it off unless MXTPU_PROFILE implies it.')
_register('MXTPU_FLIGHT_RECORDER', '', str,
          'Directory for the crash flight recorder (health.py): a bounded '
          'ring of recent spans plus a metrics snapshot, dumped '
          'atomically (resilience.atomic_replace) on exit, SIGTERM/'
          'SIGABRT, every MXTPU_FAULTS-injected kill, a serving drain '
          'and each servewatch postmortem.  Installing it turns span '
          'tracing on.  Unset: nothing installed.')
_register('MXTPU_FLIGHT_RECORDER_RING', 256, int,
          'How many recent spans a flight-recorder dump keeps (the tail '
          'across all thread buffers, read without draining them).')
_register('MXTPU_FLIGHT_RECORDER_EVERY', 8, int,
          'Write-ahead flight-recorder cadence: FlightRecorder.tick() '
          'dumps every N calls (one call per metric drain).')
# -- training-health plane (health.py) ---------------------------------------
_register('MXTPU_HEALTH_SENTINELS', False, _bool,
          'Fold on-device health sentinels into the fused fit step '
          '(health.py): a global non-finite flag over the outputs and '
          'gradients, the global gradient norm and the update-to-weight '
          'ratio, folded into fixed device buffers a captured step '
          'updates in place and read at the existing Speedometer/epoch-'
          'end metric drains: no extra host sync in steady state '
          '(health.host_syncs stays 0).')
_register('MXTPU_HEALTH_ACTION', 'warn', str,
          "What a detected non-finite step triggers at the next drain: "
          "'warn' logs; 'skip_update' additionally masks the step on the "
          "device so parameters, optimizer state, aux and the metric stay "
          "bit for bit at their values before the bad step; 'abort' "
          "raises health.TrainingDivergedError carrying the offending step "
          "range (and dumps the flight recorder when installed).")
# -- performance-attribution plane (perfwatch.py) ----------------------------
_register('MXTPU_PERFWATCH', False, _bool,
          'Enable the performance-attribution plane (perfwatch.py): the '
          'FLOPs of each captured step signature (perf.* and xla.* '
          'gauges), live MFU, step phases timed by CUDA events '
          '(perf.phase.*) and the memory ledger (mem.* gauges, one entry '
          'per graph pool).  Implies metrics.  Off: every hook is a '
          'single flag check.')
_register('MXTPU_STEP_SAMPLE', 0, int,
          'Fully synchronise every Nth fit step to measure its latency '
          '(perf.step_latency histogram, perf.host_syncs counter, a '
          'perf.step span): exactly ceil(nbatch/N) extra syncs per epoch, '
          'metric.host_syncs untouched.  0 = never.  Requires '
          'MXTPU_PERFWATCH.')
_register('MXTPU_PEAK_FLOPS', 0.0, float,
          'Override the card peak FLOP/s used as the perf.mfu '
          'denominator.  0 = the entry of perfwatch.PEAKS for the '
          'card\'s name (unknown names fall back to the H100, a CPU host '
          'to a nominal host figure).')
# -- communication-attribution plane (commwatch.py) -------------------------
_register('MXTPU_COMMWATCH', False, _bool,
          'Enable the communication-attribution plane (commwatch.py): '
          'every collective the port issues counted where it is issued '
          '(comm.all_reduce/all_gather/reduce_scatter count, bytes, '
          'wire_bytes and seconds gauges, comm.bytes_per_step), the '
          'comm-vs-compute roofline split (perf.comm_fraction against '
          'commwatch.ICI_PEAKS / MXTPU_PEAK_BW), and the step-cadence and '
          'barrier-wait histograms the kv server turns into '
          'cluster.step_skew.  Implies metrics.  Off: every hook is a '
          'single flag check.')
_register('MXTPU_PEAK_BW', 0.0, float,
          'Override the interconnect peak (bytes/sec) used as the '
          'perf.comm_fraction denominator.  0 = commwatch.ICI_PEAKS by '
          'device kind (a nominal host figure for the CPU; a card not in '
          'the table falls back to it with one warning).')
_register('MXTPU_SKEW_WARN_PCT', 0.0, float,
          'Cross-rank straggler threshold (percent): when the kv '
          "server's merged telemetry view shows the slowest rank's mean "
          'step time this far above the cluster median, the health plane '
          'logs the laggard (health.skew_warnings) and dumps a flight '
          'record naming it (health.note_skew; needs MXTPU_COMMWATCH on '
          'the workers so comm.step_time rides the heartbeats).  0 = '
          'never warn.')
# -- input-pipeline & goodput plane (iowatch.py) -----------------------------
_register('MXTPU_IOWATCH', False, _bool,
          'Enable the input-pipeline & goodput attribution plane '
          '(iowatch.py): per-stage iterator histograms '
          '(iowatch.stage.feed_wait/window_wait/...), rolling '
          'iowatch.samples_per_sec/bytes_per_sec throughput, and the '
          'goodput ledger: every second of Module.fit wall clock '
          'attributed into exclusive buckets (productive step, '
          'input_stall, compile, metric_drain, checkpoint, barrier, '
          'recovery, eval, health_skipped), published as goodput.* '
          'gauges.  Implies metrics.  Off: every hook is a single flag '
          'check.')
# -- chronicle plane (chronicle.py) ------------------------------------------
_register('MXTPU_CHRONICLE', '', str,
          'Enable the chronicle plane (chronicle.py) and name its journal '
          'directory: a background sampler scrapes the metrics registry '
          'every MXTPU_CHRONICLE_EVERY_MS into an append-only JSONL '
          'journal (counters as deltas and rates, gauges as values, '
          'histograms as cumulative-bucket vectors), segment-rotated '
          'under the MXTPU_CHRONICLE_MAX_MB ring bound with atomic '
          'commits, runs the online anomaly detectors and records every '
          'instrument.decision() event.  Implies metrics.  Empty (the '
          'default): off, no thread.')
_register('MXTPU_CHRONICLE_EVERY_MS', 500, int,
          'Chronicle sampler period in milliseconds.')
_register('MXTPU_CHRONICLE_MAX_MB', 64, int,
          'Ring bound (MiB) on the chronicle journal directory: past it '
          'the oldest closed segments are deleted.')
_register('MXTPU_CHRONICLE_DETECT', True, _bool,
          'Run the chronicle plane\'s online anomaly detectors (median/'
          'MAD baselines with hysteresis over perf.steps_per_sec, '
          'goodput.fraction, serving e2e p99, queue depth, the '
          'mem.live_bytes slope).  Off: the journal still records.')
# -- kvstore and the distributed launch (kvstore.py, kvstore_server.py,
# parallel/collectives.py) -------------------------------------------------
_register('MXNET_KVSTORE_BIGARRAY_BOUND', 1000 * 1000, int,
          'Element count above which a dist_sync push key crosses '
          'processes as its own collective; keys at or below it batch '
          'into one flat all-reduce per push group '
          '(kvstore.DistKVStore.push; env_var.md:47).')
_register('MXTPU_COORDINATOR', '', str,
          'host:port of rank 0, published by tools/launch.py: the '
          'torch.distributed TCP rendezvous of dist_sync '
          '(parallel.collectives.init_distributed).')
_register('MXTPU_NUM_PROCESSES', 1, int,
          'Number of worker processes in the job (tools/launch.py).')
_register('MXTPU_PROCESS_ID', 0, int,
          'This worker\'s rank (tools/launch.py).')
_register('MXTPU_KV_SERVER_ADDR', '', str,
          'host:port of the dist_async kv server, co-located with rank 0 '
          '(tools/launch.py publishes it; unset, rank 0 binds a port the '
          'OS picks and publishes it in its own environment).')
_register('MXTPU_IS_RECOVERY', False, _bool,
          'The launcher respawned this worker into a running job '
          '(kvstore.DistAsyncKVStore.is_recovery).')
_register('MXTPU_KV_RPC_TIMEOUT', 30.0, float,
          'Per-attempt wait for an async-kvstore RPC reply before the '
          'client retries (resilience.RetryPolicy; the ps-lite van '
          'resend timeout).')
_register('MXTPU_KV_OP_DEADLINE', 120.0, float,
          'Total wall-clock budget for one async-kvstore operation '
          'including all retries; exceeded => ConnectionError.')
_register('MXTPU_KV_BARRIER_TIMEOUT', 300.0, float,
          'Deadline for barrier(), client- and server-side: past it the '
          'server replies an error instead of holding the worker '
          '(kvstore_server._barrier_wait).')
_register('MXTPU_KV_DEAD_TIMEOUT', 5.0, float,
          'Heartbeat staleness (seconds) after which the server counts '
          'a rank dead and excludes it from barrier accounting '
          '(kvstore_dist.h:151-160 get_num_dead_node).')
_register('MXTPU_KV_MAX_PENDING', 512, int,
          'Max un-acked pushes a worker may buffer for crash replay '
          'before push() applies backpressure (bounds replay memory).')
_register('MXTPU_KV_RETRY_BASE', 0.05, float,
          'First reconnect/retry backoff (seconds); doubles per attempt '
          'up to MXTPU_KV_RETRY_MAX, scaled by MXTPU_KV_RETRY_JITTER.')
_register('MXTPU_KV_RETRY_MAX', 2.0, float,
          'Backoff ceiling (seconds) for kvstore retry/reconnect.')
_register('MXTPU_KV_RETRY_JITTER', 0.25, float,
          'Uniform jitter fraction added to each backoff delay '
          '(decorrelates worker retry storms after a server restart).')
_register('MXTPU_KV_RECONNECT_DEADLINE', 60.0, float,
          'How long a client keeps redialing a lost kv server before '
          'declaring the connection dead and failing pending ops.')
_register('MXTPU_KV_SERVER_BACKING', '', str,
          'Path the async kv server persists its store + replay '
          'watermarks to (atomic commit per MXTPU_KV_SERVER_SYNC_EVERY '
          'pushes); a restarted server restores from it so worker '
          'replay completes training with no lost pushes.')
_register('MXTPU_KV_SERVER_SYNC_EVERY', 1, int,
          'Persist the server store every N applied pushes when '
          'MXTPU_KV_SERVER_BACKING is set (1 = every push: exactly-once '
          'replay; larger trades durability for throughput).')
_register('MXTPU_ELASTIC', False, _bool,
          'Arm the kv server\'s elastic membership plane (dead-rank '
          'eviction, generation numbers, the join RPC).  The fit loop\'s '
          'coordinator (elastic.py) is not ported yet; the server '
          'reads the knob.')
_register('MXTPU_TELEMETRY', True, _bool,
          'Piggyback a compact metrics delta on the dist_async '
          'heartbeat connection (protocol v2 extension, versioned and '
          'ignored by old servers) so the kv server aggregates a '
          'cluster-wide telemetry view (telemetry RPC, '
          'kvstore.DistAsyncKVStore.telemetry).  Only active when the '
          'metrics registry is on.')
_register('MXTPU_TELEMETRY_DIR', '', str,
          'Directory where the dist_async kv server serves the merged '
          'cluster telemetry as cluster_status.json plus Prometheus '
          'text exposition cluster_status.prom '
          '(instrument.render_prometheus), rewritten atomically at '
          'most once a second as worker deltas arrive.')
# -- fault injection (resilience.py) -----------------------------------------
_register('MXTPU_FAULTS', '', str,
          'Fault-injection plan (resilience.py grammar: '
          'site:action[:arg[:arg2]] joined by ";"; the serving fleet\'s '
          'sites are serve.execute.r<id>, serve.flush.r<id> and '
          'serve.worker.r<id>).  Unset: every fault hook is a single '
          'flag check.')
_register('MXTPU_FAULTS_SEED', 0, int,
          'RNG seed for MXTPU_FAULTS coin flips (deterministic chaos).')


def describe(effective_only=False):
    """The catalog of the knobs this package reads (the analogue of
    docs/how_to/env_var.md), in the JAX package's format
    (``mxnet_tpu/config.py:600``).  Every knob registered here is read,
    so ``effective_only`` leaves none out."""
    lines = []
    for knob in sorted(_REGISTRY.values()):
        lines.append('%s (default %r)\n    %s'
                     % (knob.name, knob.default, knob.doc))
    return '\n'.join(lines)


def list_knobs():
    return sorted(_REGISTRY)


def get(name):
    """Read a registered knob from the environment (typed)."""
    knob = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return knob.parse(raw)

