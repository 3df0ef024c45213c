#!/usr/bin/env python3
"""Where the time of a ResNet-50 v2 training step goes, on the GPU, in
the PyTorch port (mxnet_tpu_torch).

    python3 tools/torch_profile_training.py [--rows 32] [--steps 5]

Builds full-width ResNet-50 v2 (1000 classes, 3x224x224) with random
weights from a numpy seed, trains it with Module.fit (bf16 compute, SGD
lr 0.05 momentum 0.9 wd 1e-4, MXTPU_FUSE=aggressive) for two warm-up
steps, then runs ``--steps`` more fused train steps under torch.profiler:
wall and device-busy time per step, the device's idle share, kernel
time by class and by name, kernels launched per step.  Prints one JSON
line; needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rows', type=int, default=32)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import resnet
    from torch_profile_serving import profile_window
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    shape = (args.rows, 3, 224, 224)
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50)
    arg, aux = convert.random_params(symbol, {'data': shape}, args.seed)
    rng = np.random.default_rng(args.seed + 1)
    images = rng.standard_normal((2 * args.rows,) + shape[1:],
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, 2 * args.rows).astype(np.float32)
    it = mx.io.NDArrayIter(images, labels, batch_size=args.rows)
    mod = mx.mod.Module(symbol, context=mx.gpu(0),
                        compute_dtype=torch.bfloat16)
    mod.fit(it, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': 0.05, 'momentum': 0.9,
                              'wd': 1e-4},
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    it.reset()
    batch = next(it)
    metric = mx.metric.create('acc')
    mod._fit_step(batch, metric)            # builds the step for the metric
    torch.cuda.synchronize()
    out = profile_window(torch, lambda: mod._fit_step(batch, metric),
                         args.steps, unit='step')
    out.update(card=smi, rows=args.rows, compute_dtype='bfloat16',
               fuse='aggressive')
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
