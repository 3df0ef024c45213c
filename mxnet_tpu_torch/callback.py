"""Training callbacks — the port of ``mxnet_tpu/callback.py``
(reference ``python/mxnet/callback.py``): ``module_checkpoint``,
``do_checkpoint``, ``log_train_metric``, ``Speedometer`` and
``ProgressBar``."""
from __future__ import annotations

import logging
import math
import time

__all__ = ['module_checkpoint', 'do_checkpoint', 'log_train_metric',
           'Speedometer', 'ProgressBar']


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback that checkpoints ``mod`` every ``period``
    epochs (callback.py:9): ``mod.save_checkpoint(prefix, epoch + 1,
    save_optimizer_states)``."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """An epoch-end callback that saves the symbol and the parameters it
    is given every ``period`` epochs (callback.py:31)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """A batch-end callback that logs the training metric every
    ``period`` batches (callback.py:54)."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info('Iter[%d] Batch[%d] Train-%s=%f',
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer(object):
    """Log training speed (and the metric) every ``frequent`` batches.

    With the fused step's device metrics, the ``get_name_value()`` call
    here is the only host sync of the steady-state fit loop: the metric
    drains its device accumulators exactly at these log points (and at
    epoch end).  Samples/sec uses the monotonic clock.

    ``health=True`` appends a health column (grad norm and non-finite
    step count from the ``MXTPU_HEALTH_SENTINELS`` probe).  It reads ONLY
    the values the metric drain above already brought to the host (the
    sentinel state rides that same transfer), so the column adds no host
    sync (empty when no fit with sentinels is active)."""

    def __init__(self, batch_size, frequent=50, health=False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.health = health
        self.init = False
        self.tic = 0
        self.last_count = 0

    def _health_column(self):
        """The drained sentinel values as a log suffix (host mirrors
        only)."""
        if not self.health:
            return ''
        from . import health as _health
        vals = _health.last_values()
        if not vals:
            return ''
        return '\tgrad_norm=%.4g\tnan_steps=%d' \
            % (vals['grad_norm'], vals['nan_steps'])

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
            # drain FIRST (the loop's host sync point), so the health
            # column reads this tick's values
            name_value = param.eval_metric.get_name_value()
            param.eval_metric.reset()
            health_col = self._health_column()
            for name, value in name_value:
                logging.info('Epoch[%d] Batch [%d]\tSpeed: %.2f '
                             'samples/sec\tTrain-%s=%f%s', param.epoch,
                             count, speed, name, value, health_col)
        else:
            logging.info('Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s',
                         param.epoch, count, speed, self._health_column())
        self.tic = time.monotonic()


class ProgressBar(object):
    """An ASCII progress bar of the batches done (callback.py:112)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = '=' * filled_len + '-' * (self.bar_len - filled_len)
        logging.info('[%s] %s%s\r', prog_bar, percents, '%')
