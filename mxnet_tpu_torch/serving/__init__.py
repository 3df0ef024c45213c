"""Serving fleet of the port: a dynamic-batching model server over
Predictors whose buckets replay CUDA graphs.

- :class:`ModelServer` — named-model registry (hot load/unload/reload),
  N replicas per model (each its own Predictor and CUDA stream) behind
  one shared admission queue with per-replica :class:`DynamicBatcher`
  workers, priority lanes (``priority='interactive'`` preempts batch
  coalescing at flush boundaries), per-lane admission bounds
  (:class:`ServerOverloadedError`), request deadlines
  (:class:`DeadlineExceededError`), drain and SIGTERM drain.
- :class:`FleetSupervisor` — the detect→repair loop
  (``server.supervise(name)`` / ``MXTPU_SERVE_SUPERVISE``): a wedged or
  dead replica is quarantined, its in-flight requests replayed once
  (:class:`ReplicaQuarantinedError` on a second displacement), and a
  warmed replacement attached before the tear-down.

The reference's ``ReplicaAutoscaler`` (with brownout) and
``servewatch`` are not ported yet.  Importing this package starts
nothing: threads exist only per constructed server.
"""
from .batcher import (DeadlineExceededError, DynamicBatcher,
                      ReplicaQuarantinedError, ServerOverloadedError,
                      LANE_BATCH, LANE_INTERACTIVE)
from .server import ModelNotFoundError, ModelServer
from .supervisor import FleetSupervisor

__all__ = ['ModelServer', 'DynamicBatcher', 'ServerOverloadedError',
           'DeadlineExceededError', 'ReplicaQuarantinedError',
           'ModelNotFoundError', 'FleetSupervisor',
           'LANE_BATCH', 'LANE_INTERACTIVE']
