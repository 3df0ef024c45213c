"""Serving fleet of the port: a dynamic-batching model server over
Predictors whose buckets replay CUDA graphs.

- :class:`ModelServer` — named-model registry (hot load/unload/reload),
  N replicas per model (each its own Predictor and CUDA stream) behind
  one shared admission queue with per-replica :class:`DynamicBatcher`
  workers, priority lanes (``priority='interactive'`` preempts batch
  coalescing at flush boundaries), per-lane admission bounds
  (:class:`ServerOverloadedError`), request deadlines
  (:class:`DeadlineExceededError`), drain and SIGTERM drain.
- :class:`ReplicaAutoscaler` — the closed-loop controller holding the
  WINDOWED p99 at an SLO (``server.autoscale(name, slo_p99_ms=...)``):
  scale replicas up/down, shrink/restore the max batch, and with
  brownout shed the batch lane before interactive traffic sheds; every
  decision logged as an event.
- :mod:`~mxnet_tpu_torch.serving.servewatch` — the request-attribution
  plane (``MXTPU_SERVEWATCH``): per-request span chains whose six
  exclusive buckets sum to e2e, flush composition records, histogram
  exemplars and capped tail postmortems through the flight recorder.
- :class:`FleetSupervisor` — the detect→repair loop
  (``server.supervise(name)`` / ``MXTPU_SERVE_SUPERVISE``): a wedged or
  dead replica is quarantined, its in-flight requests replayed once
  (:class:`ReplicaQuarantinedError` on a second displacement), and a
  warmed replacement attached before the tear-down.

Importing this package starts nothing: threads exist only per
constructed server (and per autoscaler or supervisor it enrolls).
"""
from . import servewatch
from .autoscaler import ReplicaAutoscaler
from .batcher import (DeadlineExceededError, DynamicBatcher,
                      ReplicaQuarantinedError, ServerOverloadedError,
                      LANE_BATCH, LANE_INTERACTIVE)
from .server import ModelNotFoundError, ModelServer
from .supervisor import FleetSupervisor

__all__ = ['ModelServer', 'DynamicBatcher', 'ServerOverloadedError',
           'DeadlineExceededError', 'ReplicaQuarantinedError',
           'ModelNotFoundError', 'ReplicaAutoscaler',
           'FleetSupervisor', 'servewatch',
           'LANE_BATCH', 'LANE_INTERACTIVE']
