"""Monitor — tap intermediate op outputs during training; the port of
``mxnet_tpu/monitor.py`` (reference ``python/mxnet/monitor.py``).

``install`` hands the executor a callback and the name pattern
(``Executor.set_monitor_callback``).  While the monitor is active (every
``interval`` batches, from ``tic`` to ``toc``) the executor's forward runs
the original symbol, not the fused program, so taps key on the original
node names, and hands every output whose name matches to the callback.
``toc`` also appends each executor's outputs, sorts by name with
``sort=True`` and formats each stat as the reference does.
"""
from __future__ import annotations

import logging
import math
import re

from .ndarray import NDArray

__all__ = ['Monitor']


class Monitor(object):
    """Tap outputs matching a name pattern (reference monitor.py:16)."""

    def __init__(self, interval, stat_func=None, pattern='.*', sort=False):
        if stat_func is None:
            def asum_stat(x):
                """``norm(x) / sqrt(x.size)``, the reference's default
                stat"""
                from . import ndarray as nd
                return nd.norm(x) / math.sqrt(x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Tap ``exe``'s forward (outputs named by the pattern only)."""
        exe.set_monitor_callback(self.stat_helper, self.re_prog)
        self.exes.append(exe)

    def tic(self):
        """Start a batch: activate every ``interval`` batches."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End a batch: ``[(step, name, stat string)]`` of the taps and
        of each executor's outputs (empty when not active)."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe.output_names, exe.outputs):
                self.queue.append((self.step, name, self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                raise TypeError('stat_func must return an NDArray or a '
                                'list of them, got %r' % type(v_list))
            s = ''
            for v in v_list:
                if v.shape == (1,):
                    s += str(v.asscalar()) + '\t'
                else:
                    s += str(v.asnumpy()) + '\t'
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """``toc`` and log each line."""
        res = self.toc()
        for n, k, v in res:
            logging.info('Batch: {:7d} {:30s} {:s}'.format(n, k, v))
