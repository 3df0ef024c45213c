#!/usr/bin/env python3
"""``PrefetchingIter`` of two trees of the port on the card, in turns:
``chip_smoke.py``'s mnist-lenet epoch (MNIST_IMAGES seeded 28x28 images
in idx files, LeNet at batch 128, SGD, device feed off) over
``MNISTIter`` alone and over ``PrefetchingIter(MNISTIter)``.

    python3 tools/torch_prefetch_probe.py --parent DIR [--rounds 2]
        [--reps 2] [--out FILE]

``--parent`` is another tree of the repo (a ``git archive`` of the
parent commit, say).  Each round runs one child process per tree in the
order parent, this tree, this tree, parent, so both see the same drift
of the host.  Each child, over its own tree's ``mxnet_tpu_torch`` and
``chip_smoke.py``, writes the idx files, runs one short untimed fit over
``PrefetchingIter`` (building what the first use builds), then ``--reps``
times: a drain of each iterator with no model (``for batch in it``), and
one fit epoch over each.  It reports images/s of each, and the ratio
prefetching / plain within the child, which cancels the host's speed
from one process to the next.  Prints one JSON line per child and a
summary line (the median of each figure per tree); ``--out`` writes them
all.  Exits nonzero without a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, shutil, statistics, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, models

reps = int(sys.argv[1])
tmp = tempfile.mkdtemp()
rng = np.random.default_rng(cs.SEED + 7)
images = rng.integers(0, 256, (cs.MNIST_IMAGES, 28, 28), dtype=np.uint8)
labels = rng.integers(0, 10, cs.MNIST_IMAGES, dtype=np.uint8)
img, lab = os.path.join(tmp, 'images'), os.path.join(tmp, 'labels')
cs.write_idx(img, images)
cs.write_idx(lab, labels)
lenet = models.get_symbol('lenet', num_classes=10)
arg, _ = convert.random_params(lenet, {'data': (cs.MNIST_BATCH, 1, 28, 28)},
                               cs.SEED)


def mnist():
    return mx.io.MNISTIter(image=img, label=lab, batch_size=cs.MNIST_BATCH,
                           shuffle=True, seed=cs.SEED)


def prefetching():
    return mx.io.PrefetchingIter(mnist())


def drain(make):
    it = make()
    n = 0
    t0 = time.perf_counter()
    for batch in it:
        n += cs.MNIST_BATCH - (getattr(batch, 'pad', 0) or 0)
    secs = time.perf_counter() - t0
    close = getattr(it, 'close', None)
    if close is not None:
        close()
    return n / secs


cs.epoch_report(mx, torch, lenet, arg,
                lambda: mx.io.PrefetchingIter(mx.io.ResizeIter(mnist(), 8)),
                False, 8 * cs.MNIST_BATCH)
out = {'drain_mnist_iter': [], 'drain_prefetching_iter': [],
       'fit_mnist_iter': [], 'fit_prefetching_iter': []}
for _ in range(reps):
    out['drain_mnist_iter'].append(drain(mnist))
    out['drain_prefetching_iter'].append(drain(prefetching))
    out['fit_mnist_iter'].append(cs.epoch_report(
        mx, torch, lenet, arg, mnist, False, cs.MNIST_IMAGES)['images_per_s'])
    out['fit_prefetching_iter'].append(cs.epoch_report(
        mx, torch, lenet, arg, prefetching, False,
        cs.MNIST_IMAGES)['images_per_s'])
shutil.rmtree(tmp)
med = {k: statistics.median(v) for k, v in out.items()}
out['drain_ratio'] = med['drain_prefetching_iter'] / med['drain_mnist_iter']
out['fit_ratio'] = med['fit_prefetching_iter'] / med['fit_mnist_iter']
print(json.dumps(out))
'''


def child(root, reps):
    done = subprocess.run([sys.executable, '-c', CHILD, str(reps)], cwd=root,
                          env=dict(os.environ), capture_output=True,
                          text=True, timeout=600)
    if done.returncode:
        raise RuntimeError('%s: %s' % (root, done.stderr[-3000:]))
    return json.loads(done.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True)
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_prefetch_probe: no CUDA device', file=sys.stderr)
        return 1
    trees = {'parent': os.path.abspath(args.parent), 'change': ROOT}
    rows = []
    for rnd in range(args.rounds):
        for tree in ('parent', 'change', 'change', 'parent'):
            row = dict(child(trees[tree], args.reps), tree=tree, round=rnd)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {'summary': {tree: {
        k: statistics.median(statistics.median(r[k]) if isinstance(r[k], list)
                             else r[k] for r in rows if r['tree'] == tree)
        for k in ('drain_mnist_iter', 'drain_prefetching_iter',
                  'fit_mnist_iter', 'fit_prefetching_iter', 'drain_ratio',
                  'fit_ratio')} for tree in trees}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows + [summary], f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
