#!/usr/bin/env python3
"""Where the time of a served ResNet-50 v2 (or SSD) forward goes, on the
GPU, in the PyTorch port (mxnet_tpu_torch).

    python3 tools/torch_profile_serving.py [--rows 32] [--iters 20]
    python3 tools/torch_profile_serving.py --model ssd-vgg16 --rows 8

Builds full-width ResNet-50 v2 (1000 classes, 3x224x224), or SSD-VGG16
(20 classes, 3x300x300, 7308 anchors; relu4_3_scale at its Constant(20)
init), with random weights from a numpy seed and a serving Predictor
(pow2 buckets) for
three modes: MXTPU_FUSE=off and =aggressive built under NaiveEngine (op
by op, the request uploaded from pageable memory), and aggressive
captured (the bucket's forward one CUDA graph, the request staged
through pinned memory).  It times the forward at ``--rows`` rows in
turns (each mode, then again in reverse order): host wall per forward
(ending in a synchronize) and device time from CUDA events around the
same forwards.  Then a torch.profiler window over each mode's forwards
gives the device's busy time per forward (union of kernel intervals),
its idle share, and kernel time by class and by name.  Prints one JSON
line per result; needs a CUDA device.  Convolutions run PyTorch's
default (cuDNN TF32).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# kernel-name fragments -> class, first match wins
_CLASSES = (('bn_relu_kernel', 'fused_bn_relu'),
            ('nms_masks', 'multibox_nms'), ('nms_scan', 'multibox_nms'),
            ('dotsrc', 'fused_scale_bias_dot'),
            ('convsrc', 'fused_scale_bias_conv3x3'),
            # the sm90 routes: gemm_sm90<..., hook> instantiations
            ('bnprologue', 'fused_scale_bias_dot'),
            ('convprologue', 'fused_scale_bias_conv3x3'),
            ('sm90epi', 'fused_dot_epilogue'),
            ('dot_epilogue', 'fused_dot_epilogue'),
            ('flash_fwd', 'flash_attention'),
            ('conv', 'convolution'),
            ('implicit', 'convolution'), ('winograd', 'convolution'),
            ('fft', 'convolution'),
            ('gemm', 'matmul'), ('gemv', 'matmul'), ('xmma', 'convolution'),
            ('pool', 'pooling'), ('softmax', 'softmax'),
            ('reduce', 'reduction'), ('elementwise', 'elementwise'),
            ('copy', 'copy'), ('memcpy', 'copy'), ('memset', 'copy'))


def _class(name):
    low = name.lower()
    for frag, cls in _CLASSES:
        if frag in low:
            return cls
    return 'other'


def _time_forwards(torch, pred, data, iters):
    host, dev = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pred.forward(data=data)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def profile_window(torch, run, iters, unit='forward'):
    """torch.profiler over ``iters`` calls of ``run()``: wall and device
    busy time per call, the device's idle share, kernel time by class
    and by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], defaultdict(float)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = evt.time_range
        if t.end <= t.start:
            continue
        spans.append((t.start, t.end))
        by_name[evt.name] += (t.end - t.start) / 1e3
    if not spans:
        return {'phase': 'profile', 'device_time': 'not measured',
                'reason': 'the profiler recorded no device events'}
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    busy_ms = busy / 1e3
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[_class(name)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {'phase': 'profile', unit + 's': iters,
            'wall_ms_per_' + unit: wall_ms / iters,
            'device_busy_ms_per_' + unit: busy_ms / iters,
            'device_idle_share': max(0.0, 1.0 - busy_ms / wall_ms),
            'kernel_ms_per_%s_by_class' % unit: {
                k: v / iters for k, v in sorted(by_class.items(),
                                                key=lambda kv: -kv[1])},
            'top_kernels_ms_per_' + unit: [[n[:90], v / iters]
                                           for n, v in top],
            'kernels_per_' + unit: len(spans) / iters}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=('resnet', 'ssd-vgg16'),
                    default='resnet')
    ap.add_argument('--rows', type=int, default=32)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import resnet
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.model == 'ssd-vgg16':
        shape = (args.rows, 3, 300, 300)
        symbol = mx.models.get_symbol('ssd-vgg16', num_classes=20)
    else:
        shape = (args.rows, 3, 224, 224)
        symbol = resnet.get_symbol(num_classes=1000, num_layers=50)
    arg, aux = convert.random_params(symbol, {'data': shape}, args.seed)
    if 'relu4_3_scale' in arg:
        arg['relu4_3_scale'][:] = 20.0
    params = convert.params_from_numpy(arg, aux, 'cuda:0')
    data = np.random.default_rng(args.seed + 1).standard_normal(
        shape, dtype=np.float32)
    modes = (('off', 'eager'), ('aggressive', 'eager'),
             ('aggressive', 'captured'))
    preds = {}
    for fuse, engine in modes:
        os.environ['MXTPU_FUSE'] = fuse
        mx.engine.set_engine_type('NaiveEngine' if engine == 'eager' else
                                  'ThreadedEnginePerDevice')
        pred = mx.Predictor(symbol.tojson(), params, {'data': shape},
                            pad_to_bucket=True)
        pred.warm_buckets(args.rows)
        for _ in range(3):                      # cuDNN setup, allocator
            pred.forward(data=data)
        torch.cuda.synchronize()
        preds[fuse, engine] = pred
    mx.engine.set_engine_type('ThreadedEnginePerDevice')
    times = defaultdict(list)
    for mode in modes + modes[::-1]:
        times[mode].append(_time_forwards(torch, preds[mode], data,
                                          args.iters))
    for (fuse, engine), runs in times.items():
        print(json.dumps({'phase': 'forward', 'model': args.model,
                          'fuse': fuse,
                          'engine': engine, 'rows': args.rows, 'card': smi,
                          'host_ms': [h for h, _ in runs],
                          'device_event_ms': [d for _, d in runs]}),
              flush=True)
    for (fuse, engine), pred in preds.items():
        print(json.dumps(dict(profile_window(
            torch, lambda: pred.forward(data=data), max(5, args.iters // 4)),
            model=args.model, fuse=fuse, engine=engine, card=smi,
            rows=args.rows)),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
