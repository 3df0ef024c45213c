#!/usr/bin/env python3
"""Where the first step of a process spends its time, cold against a warm
start, on the card: ``chip_smoke.py``'s Custom-headed ResNet-50 v2 (f32,
32 rows, 3 steps, the ``softmax_rtc`` head), one child process per run.

    python3 tools/torch_warm_start_probe.py [--rounds 2] [--modes main,thread,fill,warm]
        [--root DIR] [--profile] [--out FILE]

Runs, per round and in the order ``--modes`` gives (default all four), a
child process in each mode, over the ``mxnet_tpu_torch`` and
``chip_smoke.py`` of ``--root`` (default: the checkout holding this
script; a ``git archive`` of another commit compares two trees in one
call, run in turns):

- ``main``: ``Module.fit`` on the main thread, no compile cache (the
  first step runs eagerly, then records its graphs);
- ``thread``: the same fit on a thread the child starts (is the first
  eager step slower off the main thread?);
- ``fill``: ``main`` with an ``MXTPU_COMPILE_CACHE`` of the round's own
  (it records the manifest and stores the Rtc cubins);
- ``warm``: ``MXTPU_WARM_START=1`` over that directory, so the warm-up
  and the capture run in ``Module._warm_start``, on the fit's thread,
  before the first batch.

Each child wraps the port's stages with timers that synchronise the
device before and after (so the stage times add their syncs, and a
stage nested in another is in both): ``Module._warm_start``,
``compile_cache.snapshot``, ``StagedStep.warm_up`` / ``capture``,
``Module._first_step`` and each signature's warm-up ``_warm_sig``; each
row names the thread that ran it.  With ``--profile`` the first eager
step also runs under ``torch.profiler`` (CPU activities) and the row
carries its ``top`` 12 entries by self CPU ms (name, calls, ms; the
stage times then include the profiler's own cost, so read them from a
run without it).  Prints
one JSON line per child (mode, round, fit wall ms, stages) and, with
``--out``, writes them all.  Exits nonzero without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, sys, threading, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile_cache as cc, convert
from mxnet_tpu_torch.module import module as mm
from mxnet_tpu_torch.models import resnet
os.environ['MXTPU_FUSE'] = 'aggressive'
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cs.register_user_ops(mx)
stages = []


def timed(obj, name):
    f = getattr(obj, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            torch.cuda.synchronize()
            stages.append([name, threading.current_thread().name,
                           (time.perf_counter() - t0) * 1e3])
    setattr(obj, name, run)


top = []
if os.environ.get('PROBE_PROFILE'):
    plain_warm_up = cc.StagedStep.warm_up

    def profiled(self):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = plain_warm_up(self)
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:12]
        top.extend([e.key, e.count, e.self_cpu_time_total / 1e3]
                   for e in rows)
        return out
    cc.StagedStep.warm_up = profiled
for cls in (cc.StagedStep, cc.CapturedStep):
    timed(cls, 'warm_up')
    timed(cls, 'capture')
timed(cc, 'snapshot')
for name in ('_first_step', '_warm_start', '_warm_sig'):
    timed(mm.Module, name)
csym = cs.custom_symbol(mx, resnet)
arg, aux = convert.random_params(csym, {'data': (cs.BATCH,) + cs.IMAGE},
                                 cs.SEED)
rng = np.random.default_rng(cs.SEED + 11)
x = rng.standard_normal((cs.BATCH * 3,) + cs.IMAGE, dtype=np.float32)
y = rng.integers(0, 1000, cs.BATCH * 3).astype(np.float32)


def fit():
    mod = mx.mod.Module(csym, context=mx.gpu(0))
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=cs.BATCH), num_epoch=1,
            optimizer='sgd', optimizer_params=dict(cs.SGD_MOMENTUM),
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    torch.cuda.synchronize()


t0 = time.perf_counter()
if os.environ.get('PROBE_FIT_THREAD'):
    th = threading.Thread(target=fit, name='fit-thread')
    th.start()
    th.join()
else:
    fit()
print(json.dumps({'fit_wall_ms': (time.perf_counter() - t0) * 1e3,
                  'stages': stages, 'top': top}))
'''


def child(mode, cache, profile, root=ROOT):
    env = dict(os.environ)
    for k in ('MXTPU_WARM_START', 'MXTPU_COMPILE_CACHE', 'PROBE_FIT_THREAD',
              'PROBE_PROFILE'):
        env.pop(k, None)
    if profile:
        env['PROBE_PROFILE'] = '1'
    if mode == 'thread':
        env['PROBE_FIT_THREAD'] = '1'
    if mode in ('fill', 'warm'):
        env['MXTPU_COMPILE_CACHE'] = cache
    if mode == 'warm':
        env['MXTPU_WARM_START'] = '1'
    done = subprocess.run([sys.executable, '-c', CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError('%s child: %s' % (mode, done.stderr[-3000:]))
    return json.loads(done.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--modes', default='main,thread,fill,warm')
    ap.add_argument('--root', default=ROOT)
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_warm_start_probe: no CUDA device', file=sys.stderr)
        return 1
    rows = []
    for rnd in range(args.rounds):
        with tempfile.TemporaryDirectory() as cache:
            for mode in args.modes.split(','):
                row = dict(child(mode, cache, args.profile,
                                 os.path.abspath(args.root)),
                           mode=mode, round=rnd, root=args.root)
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
