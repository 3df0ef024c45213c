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
_register('MXTPU_PRECOMPILE_BUCKETS', False, _bool,
          'BucketingModule binds, warms and (on the card) captures every '
          'bucket declared via bucket_keys=[...] at fit start instead of '
          'binding each bucket lazily the first time its key appears '
          'mid-epoch.')
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
# -- fault injection (resilience.py) -----------------------------------------
_register('MXTPU_FAULTS', '', str,
          'Fault-injection plan (resilience.py grammar: '
          'site:action[:arg[:arg2]] joined by ";"; the serving fleet\'s '
          'sites are serve.execute.r<id>, serve.flush.r<id> and '
          'serve.worker.r<id>).  Unset: every fault hook is a single '
          'flag check.')
_register('MXTPU_FAULTS_SEED', 0, int,
          'RNG seed for MXTPU_FAULTS coin flips (deterministic chaos).')


def get(name):
    """Read a registered knob from the environment (typed)."""
    knob = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return knob.parse(raw)

