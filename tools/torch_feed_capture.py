#!/usr/bin/env python3
"""Captures on the hot path beside the device feed, on the card: child
processes that each run a few small MLP fits in a row (fresh ``Module``,
batches of 4, 4 and 2 rows, so every fit records two graphs on its hot
path, with ``io.DeviceFeedIter`` staging the next batch meanwhile).

    python3 tools/torch_feed_capture.py [--children 6] [--fits 3]
        [--parallel 3] [--diagnose] [--lever] [--feed 0|1] [--root DIR]
        [--out FILE]

``--lever`` makes each fit's module garbage only for the cyclic collector
(a reference to itself) and runs a full collection at the start of every
recording's body, so the previous fit's module, and its graphs, are
collected while the next fit records one: what a collection that lands
inside a recording does when the previous module is cyclic garbage (a
module that a callback's closure refers to, and that refers to the
closure, is).  ``--root`` runs the
``mxnet_tpu_torch`` of another checkout (a ``git archive`` of the parent
commit, to compare two trees in one call).

A child is red when any of its fits raises (a capture invalidated: "operation
failed due to a previous error during capture") or its parameters come
out non-finite.  Prints one JSON object: ``{"red": n, "children": n,
"runs": [...]}``, each run with its exit code, seconds, error line and,
with ``--diagnose``, what the child saw:

- ``feed_ops``: each CUDA operation of the feed's staging (pin, copy,
  event record) with the capture stream's status before and after it
  (``cuStreamIsCapturing``: 0 none, 1 active, 2 invalidated) and the
  seconds since the child started;
- ``first_invalid``: the first call on the capturing thread after which
  the capture stream read invalidated (``sys.setprofile`` over the
  recording), its Python stack, and the stack of every other thread at
  that moment;
- ``gc_in_capture``: garbage collections that ran during a recording.

Exits nonzero without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import ctypes, gc, json, os, sys, threading, time, traceback
sys.path.insert(0, os.environ['FEED_CAPTURE_ROOT'])
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile_cache as cc, io as mio

T0 = time.perf_counter()
DIAG = os.environ.get('FEED_CAPTURE_DIAG') == '1'
FITS = int(os.environ.get('FEED_CAPTURE_FITS', '3'))
LEVER = os.environ.get('FEED_CAPTURE_LEVER') == '1'
report = {'feed_ops': [], 'first_invalid': None, 'gc_in_capture': 0,
          'lever_collected': 0}
if LEVER:
    lever_plain = cc.CapturedStep._capture

    def lever_capture(self):
        body = self.body

        def collecting():
            report['lever_collected'] += gc.collect()
            return body()
        self.body = collecting
        try:
            return lever_plain(self)
        finally:
            self.body = body
    cc.CapturedStep._capture = lever_capture
_cuda = ctypes.CDLL('libcuda.so.1')
_cuda.cuStreamIsCapturing.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]


def status():
    s = cc._capture_streams.get(0)
    if s is None:
        return -1
    out = ctypes.c_int(-1)
    _cuda.cuStreamIsCapturing(ctypes.c_void_p(s.cuda_stream),
                              ctypes.byref(out))
    return out.value


if DIAG:
    in_capture = [False]
    gc.callbacks.append(lambda phase, info: (
        report.__setitem__('gc_in_capture', report['gc_in_capture'] + 1)
        if in_capture[0] and phase == 'start' else None))
    plain_place = mio._place_batch

    def traced_place(batch, place_data, place_label=None):
        def wrap(place):
            def run(v):
                before = status()
                out = place(v)
                report['feed_ops'].append(
                    ['place', before, status(),
                     round(time.perf_counter() - T0, 6)])
                return out
            return run
        return plain_place(batch, wrap(place_data),
                           wrap(place_label or place_data))
    mio._place_batch = traced_place
    plain_record = torch.cuda.Event.record

    def traced_record(self, stream=None):
        before = status()
        out = plain_record(self, stream)
        report['feed_ops'].append(['event_record', before, status(),
                                   round(time.perf_counter() - T0, 6),
                                   threading.current_thread().name])
        return out
    torch.cuda.Event.record = traced_record
    plain_capture = cc.CapturedStep._capture

    def traced_capture(self):
        me = threading.get_ident()

        def prof(frame, event, arg):
            if event not in ('c_return', 'c_exception') or \
                    report['first_invalid'] is not None:
                return
            if status() == 2:
                frames = sys._current_frames()
                report['first_invalid'] = {
                    'call': getattr(arg, '__qualname__', repr(arg)),
                    'event': event,
                    't': round(time.perf_counter() - T0, 6),
                    'stack': traceback.format_stack(frame)[-6:],
                    'others': {str(t.name): traceback.format_stack(
                        frames[t.ident])[-6:]
                        for t in threading.enumerate()
                        if t.ident != me and t.ident in frames}}
        in_capture[0] = True
        sys.setprofile(prof)
        try:
            return plain_capture(self)
        finally:
            sys.setprofile(None)
            in_capture[0] = False
    cc.CapturedStep._capture = traced_capture


class Batches(mx.io.DataIter):
    def __init__(self, x, y):
        super().__init__()
        self.x, self.y, self.i = x, y, 0
        self.batch_size = 4

    @property
    def provide_data(self):
        return [('data', (4, 6))]

    @property
    def provide_label(self):
        return [('softmax_label', (4,))]

    def reset(self):
        self.i = 0

    def next(self):
        if self.i >= len(self.x):
            raise StopIteration
        j = self.i = self.i + 4
        return mx.io.DataBatch([mx.nd.array(self.x[j - 4:j])],
                               [mx.nd.array(self.y[j - 4:j])], pad=0)


net = mx.sym.FullyConnected(mx.sym.Variable('data'), num_hidden=16,
                            name='fc1')
net = mx.sym.Activation(net, act_type='relu', name='relu1')
net = mx.sym.FullyConnected(net, num_hidden=5, name='fc2')
net = mx.sym.SoftmaxOutput(net, name='softmax')
rng = np.random.RandomState(0)
x = rng.randn(10, 6).astype(np.float32)
y = rng.randint(0, 5, 10).astype(np.float32)
err = None
try:
    for fit in range(FITS):
        m = mx.Module(net, context=mx.gpu(0))
        if LEVER:
            m._self_ref = m
        m.fit(Batches(x, y), num_epoch=2, optimizer='sgd',
              optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
              initializer=mx.init.Xavier(), eval_metric='acc')
        params = m.get_params()[0]
        if not all(np.isfinite(v.asnumpy()).all() for v in params.values()):
            raise RuntimeError('fit %d: non-finite parameters' % fit)
    torch.cuda.synchronize()
except Exception as e:
    err = '%s: %s' % (type(e).__name__, str(e).splitlines()[0][:300])
report['error'] = err
print('FEED_CAPTURE ' + json.dumps(report, default=str))
sys.exit(1 if err else 0)
'''


def run(children, fits, parallel, diagnose, feed, root=ROOT, timeout=120,
        lever=False):
    """Run ``children`` child processes, ``parallel`` at a time; returns
    the summary dict."""
    env = dict(os.environ)
    env.update(FEED_CAPTURE_ROOT=root, FEED_CAPTURE_FITS=str(fits),
               FEED_CAPTURE_DIAG='1' if diagnose else '0',
               FEED_CAPTURE_LEVER='1' if lever else '0',
               MXTPU_DEVICE_FEED='1' if feed else '0')
    for k in ('MXTPU_COMPILE_CACHE', 'MXTPU_WARM_START',
              'MXNET_ENGINE_TYPE'):
        env.pop(k, None)
    runs, queue = [], list(range(children))
    while queue:
        wave, queue = queue[:parallel], queue[parallel:]
        procs = []
        for i in wave:
            t0 = time.monotonic()
            procs.append((i, t0, subprocess.Popen(
                [sys.executable, '-c', CHILD], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for i, t0, p in procs:
            try:
                out, errs = p.communicate(timeout=timeout)
                rc = p.returncode
            except subprocess.TimeoutExpired:
                p.kill()
                out, errs = p.communicate()
                rc = 'timeout'
            rep = {}
            for line in out.splitlines():
                if line.startswith('FEED_CAPTURE '):
                    rep = json.loads(line[len('FEED_CAPTURE '):])
            row = {'child': i, 'rc': rc,
                   'secs': round(time.monotonic() - t0, 2),
                   'error': rep.get('error') if rep else
                   (errs.strip().splitlines() or ['no report'])[-1][:300],
                   'graph_resets_in_capture': errs.count(
                       'operation not permitted when stream is capturing '
                       '(function reset)')}
            if diagnose:
                row.update({k: rep.get(k) for k in
                            ('first_invalid', 'gc_in_capture',
                             'lever_collected')})
                ops = rep.get('feed_ops') or []
                row['feed_ops_during_capture'] = [
                    o for o in ops if o[1] in (1, 2) or o[2] in (1, 2)]
                row['feed_ops'] = len(ops)
            runs.append(row)
    return {'red': sum(1 for r in runs if r['rc'] != 0),
            'children': children, 'fits': fits, 'feed': bool(feed),
            'lever': bool(lever), 'root': root, 'runs': runs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--children', type=int, default=6)
    ap.add_argument('--fits', type=int, default=3)
    ap.add_argument('--parallel', type=int, default=3)
    ap.add_argument('--diagnose', action='store_true')
    ap.add_argument('--lever', action='store_true')
    ap.add_argument('--feed', type=int, default=1)
    ap.add_argument('--root', default=ROOT)
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_feed_capture: needs a CUDA device')
    summary = run(args.children, args.fits, args.parallel, args.diagnose,
                  args.feed, root=os.path.abspath(args.root),
                  lever=args.lever)
    text = json.dumps(summary, default=str)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text)
    print(text)


if __name__ == '__main__':
    main()
