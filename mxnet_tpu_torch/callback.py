"""Training callbacks — the port of ``mxnet_tpu/callback.py``'s
``Speedometer`` (reference ``python/mxnet/callback.py:89``)."""
from __future__ import annotations

import logging
import time

__all__ = ['Speedometer']


class Speedometer(object):
    """Log training speed (and the metric) every ``frequent`` batches.

    With the fused step's device metrics, the ``get_name_value()`` call
    here is the only host sync of the steady-state fit loop: the metric
    drains its device accumulators exactly at these log points (and at
    epoch end).  Samples/sec uses the monotonic clock."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.monotonic()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / \
            (time.monotonic() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            param.eval_metric.reset()
            for name, value in name_value:
                logging.info('Epoch[%d] Batch [%d]\tSpeed: %.2f '
                             'samples/sec\tTrain-%s=%f', param.epoch, count,
                             speed, name, value)
        else:
            logging.info('Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec',
                         param.epoch, count, speed)
        self.tic = time.monotonic()
