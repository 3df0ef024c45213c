#!/usr/bin/env python3
"""How far a context list's fit drifts from the one-context fit, step by
step, beside the f32 noise floor, on the card: full-width ResNet-50 v2
in f32 (TF32 off, cuDNN deterministic, ``MXTPU_FUSE=aggressive``), 32
rows a step, SGD lr 0.05 momentum 0.9 wd 1e-4, random weights and data
from ``chip_smoke.py``'s seeds.

    python3 tools/torch_kv_drift.py [--steps 6] [--roots DIR ...]
        [--out FILE]

Each root (a checkout; ``.`` by default, repeat one to compare two trees
in one call, e.g. ``--roots parent . . parent``) runs in a child process
of its own, which fits:

- ``one``: ``Module(context=gpu(0))``, the captured fused step;
- ``one_other_order``: the same over every batch's rows in another order
  (a seeded permutation): the same arithmetic summed in another order,
  so its distance from ``one`` is the f32 noise floor;
- ``two``: ``Module(context=[gpu(0), gpu(0)])``, 16 + 16 rows,
  ``kvstore='local'``.

After every step it reads the parameters and prints, per root, one JSON
line: ``max_rel`` (the largest |a - b| / max|b| over the parameters) of
``one_other_order`` and ``two`` against ``one`` at each step, and each
fit's step ms (host seconds between device synchronisations).  Exits
nonzero without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def child(root, steps):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import _kernels
    if not mx.__file__.startswith(root):
        raise SystemExit('imported %s, not the root\'s package' % mx.__file__)
    os.environ['MXTPU_FUSE'] = 'aggressive'
    _kernels.build()
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=cs.IMAGE)
    arg, aux = convert.random_params(symbol, {'data': (cs.BATCH,) + cs.IMAGE},
                                     cs.SEED)
    cs.deterministic(torch, True)
    x, y = cs.kv_data(cs.BATCH * steps)
    order = np.concatenate([b * cs.BATCH + np.random.default_rng(
        cs.SEED + 20).permutation(cs.BATCH) for b in range(steps)])

    def fit(ctx, rows):
        snaps, times, last = [], [], [0.0]
        mod = mx.mod.Module(symbol, context=ctx)

        def tick(_):
            torch.cuda.synchronize()
            times.append(time.perf_counter() - last[0])
            snaps.append({k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()})
            last[0] = time.perf_counter()
        last[0] = time.perf_counter()
        mod.fit(mx.io.NDArrayIter(x[rows], y[rows], batch_size=cs.BATCH),
                num_epoch=1, kvstore='local', optimizer='sgd',
                optimizer_params=dict(cs.SGD_MOMENTUM), eval_metric='acc',
                arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                batch_end_callback=tick)
        del mod
        cs.fresh_memory(torch)
        return snaps, [t * 1e3 for t in times]

    rows = np.arange(len(x))
    one, one_ms = fit(mx.gpu(0), rows)
    other, other_ms = fit(mx.gpu(0), order)
    two, two_ms = fit([mx.gpu(0), mx.gpu(0)], rows)
    return {'root': root, 'steps': steps,
            'max_rel': {
                'one_other_order': [cs.max_rel(a, b)
                                    for a, b in zip(other, one)],
                'two': [cs.max_rel(a, b) for a, b in zip(two, one)]},
            'step_ms': {'one': one_ms, 'one_other_order': other_ms,
                        'two': two_ms}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--roots', nargs='+', default=['.'])
    ap.add_argument('--out', default=None)
    ap.add_argument('--child', default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        import torch
        if not torch.cuda.is_available():
            print('torch_kv_drift: needs a CUDA device', file=sys.stderr)
            return 1
        print(json.dumps(child(a.child, a.steps)), flush=True)
        return 0
    rows = []
    for root in a.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--child', root,
             '--steps', str(a.steps)], stdout=subprocess.PIPE, text=True,
            timeout=600)
        if proc.returncode != 0:
            print('torch_kv_drift: the child for %s exited %d'
                  % (root, proc.returncode), file=sys.stderr)
            return 1
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(rows, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
