#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. device       — the card (torch and nvidia-smi).
2. build        — nvcc builds every kernel of csrc/ for sm_90a, in
                  parallel (one nvcc per source).
3. kernels      — each kernel's wrapper on card tensors at every shape its
                  main path gives it (shapes read from the fused graphs at
                  32 rows), held against its plain PyTorch version with
                  TF32 off, timed on the device with CUDA events (median
                  of 50, L2 evicted before each launch) beside its plain
                  version, its bound, the nearest single PyTorch call
                  (library_ms) and its host cost per call.  fused_bn_relu:
                  float32 max abs error <= 1e-6, bfloat16 within one ulp.
                  fused_scale_bias_dot / fused_scale_bias_conv3x3: f32 and
                  bf16, |got - plain| <= rtol * (|A| . |W|) elementwise,
                  the product of the magnitudes (so the bound grows with
                  K), rtol 1e-4 (f32) and 2e-2 (bf16); plus a ragged
                  off-path dot and an odd-H stride-2 conv.  The GEMM
                  kernels' bf16 path shapes must take the sm90 route
                  (TMA + wgmma, csrc/hopper_gemm.cuh; f32 the simt one);
                  each such case is also run on the wmma route (the first
                  design), checked by the same rule and timed in turns
                  with the sm90 launch (wmma_ms), and each route's launch
                  is timed on the host.  fused_scale_bias_dot takes w as
                  the transposed view of the (N, K) 1x1 weight, as the
                  path does; off the path on sm90: K = 72 with a positive
                  bias and NaN past K in scale and bias (padding zeroed
                  after the prologue), M = 1001, the N = 72 tile at
                  BN = 64, a NaN row of x (exactly that output row NaN),
                  and w contiguous against the view (the same bits).
3b. lm-kernels  — the same for the transformer LM's kernels, at the shapes
                  of its aggressive training graph at 16 x 512 tokens, bf16
                  and f32: flash_attention ([128, 512, 64] causal; O
                  within 1e-4 (f32) / 2e-2 (bf16) of P . |V| elementwise,
                  lse within 1e-4 * (1 + |lse|); library_ms is
                  F.scaled_dot_product_attention) and fused_dot_epilogue
                  ((8192, 512, 2048) with bias and relu; the GEMM rule
                  above, |A|.|W| + |bias|; library_ms is torch.addmm),
                  plus off-path cases: ragged causal attention with
                  tq < tk, non-causal, D = 128; a ragged dot with bias,
                  relu and clip (wmma route), one with no bias (sm90, the
                  N = 72 tile at BN = 64); on sm90 M = 1001, no bias with
                  a clip, and a NaN row through bias, relu and clip.
3c. rtc-kernels — kernel #6: mx.rtc.Rtc's CUDA-source form, NVRTC-compiled
                  for sm_90a and launched through the CUDA driver API
                  (csrc/rtc.cu), on card tensors, each case against its
                  plain PyTorch version and timed as above (plus the first
                  push's NVRTC seconds): the reference MXNet's GPU test
                  (expf(5x) through shared memory, within 2 ulp),
                  tests/test_rtc.py's axpy and square as CUDA bodies
                  (exact; a second shape compiles nothing, float16 a
                  second module), the softmax head of path 4 forward
                  (within rtol 1e-5 of torch.softmax in float64;
                  library_ms is torch.softmax) and backward (y -
                  onehot(label), exact; library_ms is torch.scatter_add
                  of -1 at the labels) at (32, 1000)
                  and, off the path, at the LM head's (8192, 32000); a
                  body with a syntax error raises with NVRTC's log.
4. serve       — main path 1: ModelServer serves full-width ResNet-50 v2
                  (1000 classes, 3x224x224, random weights from a numpy
                  seed, MXTPU_FUSE=aggressive, pow2 buckets up to 32
                  rows): after one warm-up request per bucket, 64 requests
                  of 1-8 rows from 4 client threads.  Launch counts are
                  zeroed just before and read just after; fused_bn_relu
                  must launch 17 times per forward.
5. parity       — 4 rows through the served model and through a CPU
                  Predictor, TF32 off: rtol 1e-3, same top-1.
6. train        — main path 2: Module(resnet-50 v2, 1000 classes,
                  3x224x224, context=gpu(0), compute_dtype=bfloat16).fit
                  over an NDArrayIter of 10 batches of 32 random images and
                  labels, SGD lr 0.05 momentum 0.9 wd 1e-4,
                  MXTPU_FUSE=aggressive.  Counts zeroed just before fit and
                  read just after: per step 36 fused_scale_bias_dot (all
                  on the sm90 route), 16 fused_scale_bias_conv3x3 and as
                  many fused_bn_relu as the training graph has _bn_relu
                  nodes.  Loss and parameters
                  finite, parameters moved; step ms (median after 2
                  warm-up steps), images/s, peak device memory.
7. train-parity — one fused step of the full-width model at 2 rows,
                  float32, TF32 off, on the card and on the CPU from the
                  same numpy parameters: updated parameters rtol 1e-3,
                  atol 1e-5, except isolated relu-kink flips (at most 1e-4
                  of the elements, none beyond 1e-3; see the phase).
8. lm-train     — main path 3, the JAX package's transformer-LM bench leg
                  (bench.py:958-994) through the port's
                  parallel.make_train_step: V=32000, E=512, 8 heads, 6
                  layers, T=512, 16 rows, bf16 compute over f32 masters,
                  SGD lr 0.01 momentum 0.9, MXTPU_FUSE=aggressive, N(0,
                  0.02²) weights from numpy RandomState(0), 10 steps.
                  Counts zeroed just before and read just after: 6
                  flash_attention and 6 fused_dot_epilogue (all on the
                  sm90 route) per step.
                  Output and parameters finite, parameters moved;
                  cross-entropy of the first and last step (ln 32000 =
                  10.37), step ms (median after 2 warm-up steps),
                  tokens/s, peak device memory.
9. lm-parity    — one f32 step of the full-width LM at 2 x 512 tokens,
                  TF32 off, on the card and on the CPU from the same numpy
                  parameters, under train-parity's bound.
10. imperative  — a fixed script of nd.* calls (one op of each family of
                  the imperative layer, NDArray arithmetic, indexing,
                  in-place updates, nd.Custom on the Sqr op of
                  tests/test_operator_custom.py) under `with mx.gpu(0):`
                  and on cpu() from the same numpy inputs: rtol 1e-5,
                  exact for integer, indexing and data-movement ops;
                  mx.random moments and seed determinism on each.
11. custom-train — main path 4: the train phase's model, data and
                  optimizer in float32, with SoftmaxOutput replaced by a
                  Custom head (op_type 'softmax_rtc', user code in this
                  file) whose operator pushes two Rtc kernels on the card.
                  Counts zeroed just before fit and read just after: 2 Rtc
                  launches per step and the training graph's counts of the
                  other kernels (fused_scale_bias_dot on the simt
                  route).  Loss and parameters finite, parameters moved;
                  step ms, images/s, peak device memory.
12. custom-parity — one f32 step of that model at 2 rows on the card (Rtc
                  head) and on the CPU (nd.* head, the same Custom op's
                  CPU operator), under train-parity's bound.

Then the card's nvidia-smi line, the kernels summary line (the two GEMM
kernels' entries also carry path_route, launches_by_route, wmma_ms,
host_us and launch_host_us), and the result line {"ok": true,
"device": {...}}.  Without a CUDA device, or
without the mxnet_tpu_torch package beside it, the script exits nonzero
and prints no result.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM dense bf16 on the tensor cores
GEMM_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# the route each GEMM kernel must take at the training paths' shapes
PATH_ROUTE = {'bfloat16': 'sm90', 'float32': 'simt'}
# flash_attention: bf16 rounds P for the PV product and O on each side (3 *
# 2^-8 of P.|V|, ops/attention.py); f32 differs in summation order only
ATT_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
LSE_RTOL = 1e-4
# the transformer LM of the JAX package's bench leg (bench.py:958-994)
LM = dict(vocab_size=32000, num_embed=512, num_heads=8, num_layers=6,
          seq_len=512)
LM_BATCH = 16
LM_STEPS = 10
LM_PARITY_ROWS = 2
BATCH = 32
TRAIN_BATCHES = 10
TRAIN_WARMUP = 2
PARITY_ROWS = 2
IMAGE = (3, 224, 224)
N_REQUESTS = 64
N_CLIENTS = 4
SEED = 0


def log(obj):
    print(json.dumps(obj), flush=True)


def reset_launches(kernel):
    """Zero a wrapper's launch count (and its counts by route)."""
    kernel.launches = 0
    if hasattr(kernel, 'launches_by_route'):
        kernel.launches_by_route = dict.fromkeys(kernel.launches_by_route, 0)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bn_relu_shapes(mx, symbol, batch):
    """Counter of the input shapes the fused BN-ReLU nodes of the
    aggressive inference graph receive at ``batch`` rows."""
    prog = mx.fuse.apply_fuse_passes(symbol, False, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch,) + IMAGE)
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    shapes = Counter()
    for n in prog.topo_nodes():
        if n.op == '_bn_relu':
            src, idx = n.inputs[0]
            shapes[tuple(shape_of[src.output_names()[idx]])] += 1
    return shapes


def cuda_ms_each(torch, fns, flush, reps=50, warmup=10):
    """Median device time (ms) of each of ``fns`` from CUDA events, the
    functions launched in turns, run after run, so that all see the same
    card state.  Before each run a read of ``flush`` (larger than the 50 MB
    L2) evicts the inputs; a read leaves no dirty lines whose write-back
    would land in the timed run.  A spin kernel first holds the stream
    while the host enqueues every run, so the events bracket device work
    only and not the host's Python/launch overhead (see :func:`host_us`)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = [[] for _ in fns]
    for _ in range(warmup + reps):
        for fn, runs in zip(fns, pairs):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            runs.append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in runs[warmup:])
            for runs in pairs]


def cuda_ms(torch, fn, flush, reps=50, warmup=10):
    """Median device time (ms) of ``fn`` (:func:`cuda_ms_each`)."""
    return cuda_ms_each(torch, (fn,), flush, reps, warmup)[0]


def host_us(torch, fn, reps=200):
    """Median host time of one ``fn`` call (us): the wrapper's checks,
    allocation and launch, without waiting for the device."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if len(times) % 50 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bf16_ulp(v):
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def check_bn_relu(torch, fused, shape, dtype, gen, flush):
    """One fused_bn_relu case on the card: error vs plain, times, bound."""
    dev = torch.device('cuda', 0)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    s = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype)
    b = (torch.randn(c, generator=gen, device=dev) * 0.5).to(dtype)
    got = fused.fused_bn_relu(x, s, b)
    want = fused.fused_bn_relu_plain(x, s, b)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != x.shape:
        raise AssertionError('fused_bn_relu %s %s: got %s %s'
                             % (shape, dtype, got.dtype, tuple(got.shape)))
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if not np.all(np.isfinite(g)):
        raise AssertionError('fused_bn_relu %s: non-finite output' % (shape,))
    err = float(np.max(np.abs(g - w)))
    if dtype == torch.float32:
        tol_ok, tol = err <= 1e-6, '1e-6'
    else:
        tol_ok = bool(np.all(np.abs(g - w) <=
                             bf16_ulp(np.maximum(np.abs(g), np.abs(w)))))
        tol = '1 bf16 ulp'
    if not tol_ok:
        raise AssertionError('fused_bn_relu %s %s disagrees with its plain '
                             'version: max abs err %g (tolerance %s)'
                             % (shape, dtype, err, tol))
    ms = cuda_ms(torch, lambda: fused.fused_bn_relu(x, s, b), flush)
    plain_ms = cuda_ms(torch, lambda: fused.fused_bn_relu_plain(x, s, b),
                       flush)
    wrapper_us = host_us(torch, lambda: fused.fused_bn_relu(x, s, b))
    numel = x.numel()
    nbytes = 2 * numel * x.element_size() + 2 * c * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 3 * numel / FP32_FLOPS * 1e3
    return {'shape': list(shape), 'dtype': str(dtype).replace('torch.', ''),
            'max_abs_err': err, 'tolerance': tol, 'ms': ms,
            'plain_ms': plain_ms, 'host_us': wrapper_us,
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes}


def train_kernel_shapes(mx, symbol, batch):
    """The shapes the aggressive TRAINING graph gives each kernel at
    ``batch`` rows, read from the graph: Counters of dot (M, K, N), conv
    (N, H, W, C, F, stride) and BN-ReLU input shapes."""
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch,) + IMAGE)
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    dots, convs, bn_relus = Counter(), Counter(), Counter()
    for n in prog.topo_nodes():
        if n.op not in ('_bn_relu_conv', '_bn_relu'):
            continue
        src, idx = n.inputs[0]
        d = tuple(shape_of[src.output_names()[idx]])
        if n.op == '_bn_relu':
            bn_relus[d] += 1
            continue
        nb, h, w, c = d if n.attrs.get('in_layout') == 'NHWC' else \
            (d[0], d[2], d[3], d[1])
        f = int(n.attrs['num_filter'])
        stride = tuple(n.attrs['stride'])[0]
        if tuple(n.attrs['kernel']) == (1, 1):
            oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
            dots[(nb * oh * ow, c, f)] += 1
        else:
            convs[(nb, h, w, c, f, stride)] += 1
    return dots, convs, bn_relus


def routed_call(kernel, fn):
    """``fn()`` and the route of the one launch of ``kernel`` it made,
    read from the wrapper's ``launches_by_route``."""
    before = dict(kernel.launches_by_route)
    out = fn()
    moved = [r for r, n in kernel.launches_by_route.items()
             if n != before[r]]
    if len(moved) != 1 or kernel.launches_by_route[moved[0]] != \
            before[moved[0]] + 1:
        raise AssertionError('expected one launch on one route, got %s'
                             % {r: kernel.launches_by_route[r] - before[r]
                                for r in before})
    return out, moved[0]


def _gemm_err(torch, name, dt, got, want, magnitude, nan_row):
    """max |got - want| / magnitude elementwise, after checking dtype and
    shape, and that only ``nan_row`` (if any) holds NaN, in every
    element; that row is left out of the comparison."""
    if str(got.dtype).replace('torch.', '') != dt or \
            got.shape != want.shape:
        raise AssertionError('%s %s: got %s %s, want %s' % (
            name, dt, got.dtype, tuple(got.shape), tuple(want.shape)))
    if nan_row is not None:
        nan = torch.isnan(got.float())
        rows = [int(r) for r in torch.nonzero(nan.any(1)).flatten()]
        if rows != [nan_row] or not bool(nan[nan_row].all()):
            raise AssertionError('%s %s: a NaN in row %d of x reached '
                                 'output rows %s (all of its row: %s)'
                                 % (name, dt, nan_row, rows[:8],
                                    bool(nan[nan_row].all())))
        keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
        keep[nan_row] = False
        got, want, magnitude = got[keep], want[keep], magnitude[keep]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError('%s %s: non-finite output' % (name, dt))
    err = (got.float() - want.float()).abs()
    ratio = float((err / magnitude.clamp_min(1e-30)).max())
    if ratio > GEMM_RTOL[dt]:
        raise AssertionError('%s %s disagrees with its plain version: '
                             'max |err| / (|A|.|W|) = %g > %g (max abs err '
                             '%g)' % (name, dt, ratio, GEMM_RTOL[dt],
                                      float(err.max())))
    return float(err.max()), ratio


def _gemm_case(torch, name, dtype, got, want, magnitude, timed, nbytes,
               flops, flush, route=None, launches=None, nan_row=None):
    """Check ``got`` against ``want`` elementwise within rtol * magnitude
    (|A| . |W|, the bound a K-term sum's rounding scales with), then time
    the kernel, the plain version and the library call.  ``route``: the
    route ``got`` took; ``launches``: route -> the same call forced onto
    that route (the taken one, and for a bf16 call on sm90 also 'wmma'),
    each checked by the same rule and timed for its host cost; the wmma
    route's device time (wmma_ms) is taken in turns with the kernel's."""
    dt = str(dtype).replace('torch.', '')
    torch.cuda.synchronize()
    max_err, ratio = _gemm_err(torch, name, dt, got, want, magnitude,
                               nan_row)
    launches = launches or {}
    route_errs = {}
    for r, fn in launches.items():
        out = fn()
        torch.cuda.synchronize()
        route_errs[r] = _gemm_err(torch, '%s (%s route)' % (name, r), dt,
                                  out, want, magnitude, nan_row)[1]
    kernel, plain, library = timed
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak * 1e3
    wmma = launches.get('wmma') if route == 'sm90' else None
    if wmma is not None:
        ms, wmma_ms = cuda_ms_each(torch, (kernel, wmma), flush)
    else:
        ms, wmma_ms = cuda_ms(torch, kernel, flush), None
    case = {'dtype': dt, 'max_abs_err': max_err,
            'max_err_over_magnitude': ratio,
            'tolerance': '%g * (|A|.|W|)' % GEMM_RTOL[dt],
            'ms': ms, 'plain_ms': cuda_ms(torch, plain, flush),
            'library_ms': cuda_ms(torch, library, flush),
            'host_us': host_us(torch, kernel),
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes, 'flops': flops}
    if route is not None:
        case.update(route=route, wmma_ms=wmma_ms,
                    route_err_over_magnitude=route_errs,
                    launch_host_us={r: host_us(torch, fn)
                                    for r, fn in launches.items()})
    if nan_row is not None:
        case['nan_row'] = nan_row
    return case


def check_dot(torch, fused, mkn, dtype, gen, flush, positive_bias=False,
              nan_row=None):
    """One fused_scale_bias_dot case (relu on, as on the path), w passed
    as the transposed view of an (N, K) 1x1 weight, as the fuse pass
    passes it.  ``positive_bias``: bias > 0, and scale and bias are views
    of buffers whose elements past K are NaN, so that a padded channel
    not zeroed after the prologue (relu(bias) > 0 against TMA's zeros) or
    a scale or bias read past K shows in Y.  ``nan_row``: x holds a NaN
    in that row, which must reach exactly that output row."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .to(dtype).t()
    s = torch.rand(k, generator=gen, device=dev) + 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.5
    if positive_bias:
        buf = torch.full((2, k + 64), float('nan'), device=dev)
        buf[0, :k], buf[1, :k] = s, b.abs() + 0.1
        s, b = buf[0, :k], buf[1, :k]
    kernel = fused.fused_scale_bias_dot
    got, route = routed_call(kernel, lambda: kernel(x, w, s, b, relu=True))
    want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True)
    xa = torch.relu(x.float() * s + b).to(dtype)   # the normalized input
    magnitude = torch.matmul(xa.float().abs(), w.float().abs())
    launches = {r: (lambda r=r: fused._dot_launch(x, w, s, b, True, r))
                for r in ((route, 'wmma') if route == 'sm90' else (route,))}
    case = _gemm_case(
        torch, 'fused_scale_bias_dot', dtype, got, want, magnitude,
        (lambda: kernel(x, w, s, b, relu=True),
         lambda: fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True),
         lambda: torch.matmul(xa, w)),
        (m * k + k * n + m * n) * x.element_size() + 2 * k * 4,
        2 * m * n * k, flush, route, launches, nan_row)
    case['mkn'] = list(mkn)
    if positive_bias:
        case['positive_bias_nan_tail'] = True
    return case


def check_dot_layouts(torch, fused, mkn, gen):
    """fused_scale_bias_dot with w as the transposed view of an (N, K)
    weight (the path) and as a contiguous (K, N) copy of it: the same
    route and the same bits."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .bfloat16().t()
    s = torch.rand(k, generator=gen, device=dev) + 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.5
    kernel = fused.fused_scale_bias_dot
    view, route = routed_call(kernel, lambda: kernel(x, w, s, b, relu=True))
    copy, route_c = routed_call(
        kernel, lambda: kernel(x, w.contiguous(), s, b, relu=True))
    torch.cuda.synchronize()
    if (route, route_c) != ('sm90', 'sm90') or not torch.equal(view, copy):
        raise AssertionError('fused_scale_bias_dot %s: the transposed view '
                             '(%s) and the contiguous w (%s) disagree'
                             % (mkn, route, route_c))
    return {'mkn': list(mkn), 'route': route, 'bit_equal': True}


def check_conv(torch, fused_conv, shape, dtype, gen, flush):
    """One fused_scale_bias_conv3x3 case (relu on, as on the path)."""
    import torch.nn.functional as F
    dev = torch.device('cuda', 0)
    n, h, wd, c, f, stride = shape
    x = torch.randn(n, h, wd, c, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, c, f, generator=gen, device=dev)
         / (9 * c) ** 0.5).to(dtype)
    s = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev) * 0.5
    got = fused_conv.fused_scale_bias_conv3x3(x, w, s, b, stride)
    want = fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b, stride)
    xa = torch.relu(x.float() * s + b).to(dtype)   # the normalized input
    magnitude = F.conv2d(xa.float().abs().permute(0, 3, 1, 2),
                         w.float().abs().permute(3, 2, 0, 1), None, stride,
                         1).permute(0, 2, 3, 1)
    xa_cl = xa.permute(0, 3, 1, 2)     # NCHW view of NHWC memory
    w_cl = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    case = _gemm_case(
        torch, 'fused_scale_bias_conv3x3', dtype, got, want, magnitude,
        (lambda: fused_conv.fused_scale_bias_conv3x3(x, w, s, b, stride),
         lambda: fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b,
                                                           stride),
         lambda: F.conv2d(xa_cl, w_cl, None, stride, 1)),
        (n * h * wd * c + 9 * c * f + n * oh * ow * f) * x.element_size()
        + 2 * c * 4,
        2 * n * oh * ow * f * 9 * c, flush)
    case['nhwcf_stride'] = list(shape)
    return case


def lm_kernel_shapes(mx, symbol, batch, seq_len):
    """The shapes the aggressive LM training graph gives each kernel at
    ``batch`` rows: Counters of fused_dot_epilogue (M, K, N, bias, relu,
    clip) and flash_attention (BH, Tq, Tk, D, causal, scale) calls."""
    # parameter shapes from the unfused graph: the fused epilogue node
    # does not complete its inputs' shapes
    arg_shapes, _, _ = symbol.infer_shape(data=(batch, seq_len),
                                          softmax_label=(batch, seq_len))
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(
        **dict(zip(symbol.list_arguments(), arg_shapes)))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))

    def shape(entry):
        src, idx = entry
        return tuple(shape_of[src.output_names()[idx]])

    dots, atts = Counter(), Counter()
    for n in prog.topo_nodes():
        if n.op == '_fused_epilogue' and n.attrs.get('lower_kernel') and \
                n.attrs['base_op'] == 'FullyConnected':
            d, w = shape(n.inputs[0]), shape(n.inputs[1])
            steps = [s['op'] for s in n.attrs['steps']]
            dots[(d[0], int(np.prod(d[1:])), w[0],
                  not n.attrs['base_attrs'].get('no_bias', False),
                  'Activation' in steps, 'clip' in steps)] += 1
        elif n.op == 'FlashAttention':
            q, k = shape(n.inputs[0]), shape(n.inputs[1])
            atts[(q[0] * q[1], q[2], k[2], q[3], bool(n.attrs['causal']),
                  float(n.attrs['scale']))] += 1
    return dots, atts


def live_pairs(tq, tk, causal):
    """(query, key) pairs the bottom-right aligned mask keeps per head."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(min(tk, max(0, r + off + 1)) for r in range(tq))


def check_flash(torch, attention, bh, tq, tk, d, causal, scale, dtype, gen,
                flush):
    """One flash_attention case: O within rtol * (P @ |V|) of the plain
    version elementwise and lse within 1e-4 * (1 + |lse|); then the
    kernel, plain version and SDPA timed."""
    import torch.nn.functional as F
    dev = torch.device('cuda', 0)
    dt = str(dtype).replace('torch.', '')
    q = torch.randn(bh, tq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bh, tk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh, tk, d, generator=gen, device=dev).to(dtype)
    o, lse = attention._launch(q, k, v, scale, causal)
    want, want_lse = attention.flash_attention_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    if o.dtype != dtype or o.shape != q.shape or lse.shape != (bh, tq):
        raise AssertionError('flash_attention %s: got %s %s' % (
            dt, o.dtype, tuple(o.shape)))
    s = torch.einsum('btd,bsd->bts', q.float(), k.float()) * scale
    if causal:
        keep = attention._causal_keep(tq, tk, dev)
        s = torch.where(keep, s, torch.full_like(s, attention.NEG_INF))
    magnitude = torch.einsum('bts,bsd->btd', torch.softmax(s, -1),
                             v.float().abs())
    del s
    err = (o.float() - want.float()).abs()
    if not bool(torch.isfinite(o.float()).all()):
        raise AssertionError('flash_attention %s: non-finite output' % dt)
    ratio = float((err / magnitude.clamp_min(1e-30)).max())
    lse_ratio = float(((lse - want_lse).abs() / (1 + want_lse.abs())).max())
    if ratio > ATT_RTOL[dt] or lse_ratio > LSE_RTOL:
        raise AssertionError(
            'flash_attention %s %s disagrees with its plain version: max '
            '|err| / (P.|V|) = %g (tolerance %g), lse %g (tolerance %g)'
            % ((bh, tq, tk, d), dt, ratio, ATT_RTOL[dt], lse_ratio,
               LSE_RTOL))
    pairs = live_pairs(tq, tk, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4 * bh * tq
    flops = 4 * bh * d * pairs
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16
                     else FP32_FLOPS) * 1e3
    # SDPA's is_causal is top-left aligned: the same function only when
    # tq == tk.  Its fused backends take [B, H, T, D]: BH heads of one row
    library = None
    if not causal or tq == tk:
        library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal, scale=scale), flush)
    return {'bh_tq_tk_d': [bh, tq, tk, d], 'causal': causal, 'dtype': dt,
            'max_abs_err': float(err.max()),
            'max_err_over_magnitude': ratio,
            'tolerance': '%g * (P.|V|); lse %g * (1 + |lse|)'
                         % (ATT_RTOL[dt], LSE_RTOL),
            'lse_max_abs_err': float((lse - want_lse).abs().max()),
            'ms': cuda_ms(torch, lambda: attention.flash_attention(
                q, k, v, causal, scale), flush),
            'plain_ms': cuda_ms(torch, lambda: attention.flash_attention_plain(
                q, k, v, scale, causal), flush),
            'library_ms': library,
            'host_us': host_us(torch, lambda: attention.flash_attention(
                q, k, v, causal, scale)),
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes, 'flops': flops}


def check_epilogue(torch, fused, mkn, has_bias, relu, clip, dtype, gen,
                   flush, nan_row=None):
    """One fused_dot_epilogue case, W given as the transposed view of an
    (N, K) FullyConnected weight, as the fuse pass passes it.
    ``nan_row``: x holds a NaN in that row, which must reach exactly that
    output row (through the bias add, relu and clip)."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .to(dtype).t()
    b = (torch.randn(n, generator=gen, device=dev) * 0.5).to(dtype) \
        if has_bias else None
    kernel = fused.fused_dot_epilogue
    got, route = routed_call(
        kernel, lambda: kernel(x, w, b, relu=relu, clip=clip))
    want = fused.fused_dot_epilogue_plain(x, w, b, relu=relu, clip=clip)
    magnitude = torch.matmul(x.float().abs(), w.float().abs())
    if b is not None:
        magnitude = magnitude + b.float().abs()
    launches = {r: (lambda r=r: fused._epi_launch(x, w, b, relu, clip, r))
                for r in ((route, 'wmma') if route == 'sm90' else (route,))}
    case = _gemm_case(
        torch, 'fused_dot_epilogue', dtype, got, want, magnitude,
        (lambda: kernel(x, w, b, relu=relu, clip=clip),
         lambda: fused.fused_dot_epilogue_plain(x, w, b, relu=relu,
                                                clip=clip),
         (lambda: torch.addmm(b, x, w)) if b is not None
         else (lambda: torch.matmul(x, w))),
        (m * k + k * n + m * n) * x.element_size() + (4 * n if has_bias
                                                      else 0),
        2 * m * n * k, flush, route, launches, nan_row)
    case.update(mkn=list(mkn), bias=has_bias, relu=relu,
                clip=list(clip) if clip else None)
    return case


def lm_symbol(models):
    return models.get_symbol('transformer_lm', **LM)


def lm_kernels(mx, torch, attention, fused, models, gen, flush):
    """The LM phase of the kernel checks: both kernels at every shape the
    LM training graph gives them, in bf16 (the path) and f32, plus
    off-path cases (ragged and tq < tk attention, non-causal, D = 128; a
    ragged dot with bias, relu and clip; a dot with no bias)."""
    dots, atts = lm_kernel_shapes(mx, lm_symbol(models), LM_BATCH,
                                  LM['seq_len'])
    if sum(dots.values()) != LM['num_layers'] or \
            sum(atts.values()) != LM['num_layers']:
        raise AssertionError('expected %d lowered FC epilogues and %d '
                             'FlashAttention nodes, found %s / %s'
                             % (LM['num_layers'], LM['num_layers'],
                                dict(dots), dict(atts)))
    torch.backends.cuda.matmul.allow_tf32 = False
    att_cases, dot_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for (bh, tq, tk, d, causal, scale), per_step in sorted(atts.items()):
            case = check_flash(torch, attention, bh, tq, tk, d, causal, scale,
                               dtype, gen, flush)
            case['launches_per_step'] = per_step
            att_cases.append(case)
        for bh, tq, tk, d, causal in ((6, 77, 200, 64, True),
                                      (8, 256, 256, 64, False),
                                      (16, 256, 256, 128, True)):
            case = check_flash(torch, attention, bh, tq, tk, d, causal,
                               d ** -0.5, dtype, gen, flush)
            case['launches_per_step'] = 0
            att_cases.append(case)
        for (m, k, n, bias, relu, clip), per_step in sorted(dots.items()):
            case = check_epilogue(torch, fused, (m, k, n), bias, relu,
                                  (0.0, 6.0) if clip else None, dtype, gen,
                                  flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('fused_dot_epilogue %s %s took the %s '
                                     'route' % ((m, k, n), case['dtype'],
                                                case['route']))
            case['launches_per_step'] = per_step
            dot_cases.append(case)
        # (1001, 37, 130): K and N off the multiples of 8, the wmma route
        # in bf16; (256, 96, 72): the sm90 route's ragged N tile at BN 64
        for mkn, bias, relu, clip in (((1001, 37, 130), True, True,
                                       (-0.5, 0.7)),
                                      ((256, 96, 72), False, False, None)):
            case = check_epilogue(torch, fused, mkn, bias, relu, clip, dtype,
                                  gen, flush)
            case['launches_per_step'] = 0
            dot_cases.append(case)
    # the sm90 route off the path: ragged M, no bias with a clip, a NaN
    # row through bias, relu and clip
    for mkn, bias, relu, clip, nan_row in (
            ((1001, 512, 2048), True, True, None, None),
            ((512, 128, 256), False, False, (-0.5, 0.7), None),
            ((1001, 512, 2048), True, True, (0.0, 6.0), 500)):
        case = check_epilogue(torch, fused, mkn, bias, relu, clip,
                              torch.bfloat16, gen, flush, nan_row)
        if case['route'] != 'sm90':
            raise AssertionError('fused_dot_epilogue %s took the %s route'
                                 % (mkn, case['route']))
        case['launches_per_step'] = 0
        dot_cases.append(case)
    return att_cases, dot_cases


def lm_batch(torch, dev, rows):
    """``rows`` x seq_len random token ids and their next-token labels,
    as the bench leg makes them (labels = (toks + 1) % V)."""
    v = LM['vocab_size']
    toks = np.random.RandomState(SEED + 1).randint(
        0, v, (LM_BATCH, LM['seq_len'])).astype(np.float32)[:rows]
    return {'data': torch.from_numpy(toks).to(dev),
            'softmax_label': torch.from_numpy((toks + 1) % v).to(dev)}


def lm_step(ts, symbol, rows, compute_dtype):
    opt = ts.make_sgd_momentum(lr=0.01, momentum=0.9, wd=0.0,
                               rescale_grad=1.0 / (rows * LM['seq_len']))
    return ts.make_train_step(symbol, opt, ('data', 'softmax_label'),
                              compute_dtype=compute_dtype)


def cross_entropy(torch, prob, label):
    p = torch.gather(prob.float(), 1, label.reshape(-1, 1).long())
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def _sum_cases(cases, key):
    return sum(c[key] * c['launches_per_step'] for c in cases)


def gemm_summary(name, source, replaces, cases, launches_by_path,
                 library_call, per='one 32-row training step forward, '
                 'bfloat16'):
    """The kernels-line entry of a kernel timed per training step:
    per-shape bf16 medians summed over one step's forward launches."""
    on_path = [c for c in cases if c['launches_per_step']
               and c['dtype'] == 'bfloat16']
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': sum(launches_by_path.values()),
            'launches_by_path': launches_by_path,
            'max_abs_err': max(c['max_abs_err'] for c in cases
                               if c['launches_per_step']),
            'ms': _sum_cases(on_path, 'ms'),
            'plain_ms': _sum_cases(on_path, 'plain_ms'),
            'bound_ms': _sum_cases(on_path, 'bound_ms'),
            # the side that holds the larger share of the summed bound
            'bound_by': ('operations' if _sum_cases(
                [c for c in on_path if c['bound_by'] == 'operations'],
                'bound_ms') > _sum_cases(on_path, 'bound_ms') / 2
                else 'bytes'),
            'library_ms': _sum_cases(on_path, 'library_ms'),
            'library_call': library_call, 'per': per,
            'f32_ms': _sum_cases([c for c in cases if c['launches_per_step']
                                  and c['dtype'] == 'float32'], 'ms'),
            'cases': cases}


def route_summary(cases, launches_by_route):
    """The route entries of a GEMM kernel's summary: the route its bf16
    path cases took, the wmma route's device time at the same shapes
    (summed over one step's launches, like ms), host us per call (the
    public wrapper, and each route's launch alone) averaged over the
    step's launches, and the main path's launches by route."""
    on_path = [c for c in cases if c['launches_per_step']
               and c['dtype'] == 'bfloat16']
    calls = sum(c['launches_per_step'] for c in on_path)
    return {'path_route': ','.join(sorted({c['route'] for c in on_path})),
            'launches_by_route': launches_by_route,
            'wmma_ms': _sum_cases(on_path, 'wmma_ms'),
            'host_us': _sum_cases(on_path, 'host_us') / calls,
            'launch_host_us': {
                r: sum(c['launch_host_us'][r] * c['launches_per_step']
                       for c in on_path) / calls for r in ('sm90', 'wmma')}}


def param_parity(card, host):
    """Elementwise rtol 1e-3, atol 1e-5 between two parameter dicts.  A
    relu whose input lies within the two devices' float32 differences
    (~1e-6) of zero can take the other side of its kink on one device:
    its gradient element flips, and the weight gradients of the channel
    it feeds move by far more than the tolerance.  Such isolated flips
    are expected at full width (millions of relu inputs), so a phase
    fails when more than 1e-4 of all parameter elements are outside the
    tolerance, or any is more than 1e-3 away.  Returns (elements outside,
    total, worst (abs err, name), per-parameter outliers)."""
    outside, worst, total, n_out = [], (0.0, None), 0, 0
    for k in sorted(card):
        diff = np.abs(card[k] - host[k])
        bad = int((diff > 1e-5 + 1e-3 * np.abs(host[k])).sum())
        total += diff.size
        n_out += bad
        if bad:
            outside.append((k, bad, float(diff.max())))
        if float(diff.max()) > worst[0]:
            worst = (float(diff.max()), k)
    return n_out, total, worst, outside


def train_module(mx, torch, symbol, arg, aux, data, labels, ctx, dtype,
                 batch):
    """``Module.fit`` over an NDArrayIter; returns the module and the
    host seconds of each step (each ends in a device synchronise)."""
    times = []
    last = [time.perf_counter()]
    on_card = ctx.device_type == 'gpu'

    def tick(_):
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    mod = mx.mod.Module(symbol, context=ctx, compute_dtype=dtype)
    mod.fit(mx.io.NDArrayIter(data, labels, batch_size=batch),
            num_epoch=1, eval_metric=['acc', 'ce'],
            optimizer='sgd', optimizer_params={
                'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4},
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()},
            batch_end_callback=tick)
    return mod, times


def serve(server, data, rng):
    """64 requests of 1-8 rows from 4 threads; returns per-request
    (rows, latency_s, output) and the wall seconds."""
    sizes = [int(v) for v in rng.integers(1, 9, size=N_REQUESTS)]
    offsets = np.cumsum([0] + sizes[:-1]) % (len(data) - 8)
    results = [None] * N_REQUESTS
    errors = []

    def client(k):
        try:
            for i in range(k, N_REQUESTS, N_CLIENTS):
                rows = data[offsets[i]:offsets[i] + sizes[i]]
                t0 = time.monotonic()
                out = server.predict('resnet50', timeout=300, data=rows)
                results[i] = (sizes[i], time.monotonic() - t0, out[0])
        except Exception as e:                    # noqa: BLE001 - reported
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError('serving failed: %s' % (errors or 'hung'))
    return results, wall


# -- the user-extension path: Rtc kernels and Custom operators ---------------
# What a user of mx.rtc writes (MXRtc's convention): the BODY of a CUDA
# __global__ function whose parameters are the named inputs (const T*) and
# outputs (T*).  MXRtc kernels take no scalar arguments, so the row width
# is compiled in: one module per width.
#
# Row softmax, one block per row: a block-wide max, a block-wide sum of
# exp(x - max), then y = exp(x - max) / sum.  blockDim.x is a multiple of
# 32 (every lane takes part in the shuffles), at most 1024.
SOFTMAX_FWD = r'''
const int n = %(n)d;
const float* xr = x + (long long)blockIdx.x * n;
float* yr = y + (long long)blockIdx.x * n;
__shared__ float part[32];
const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
const int warps = blockDim.x >> 5;
float m = __int_as_float(0xff800000);
for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, xr[j]);
for (int o = 16; o > 0; o >>= 1)
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
if (lane == 0) part[warp] = m;
__syncthreads();
m = part[0];
for (int w = 1; w < warps; ++w) m = fmaxf(m, part[w]);
__syncthreads();
float s = 0.f;
for (int j = threadIdx.x; j < n; j += blockDim.x) s += expf(xr[j] - m);
for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
if (lane == 0) part[warp] = s;
__syncthreads();
s = 0.f;
for (int w = 0; w < warps; ++w) s += part[w];
const float inv = 1.f / s;
for (int j = threadIdx.x; j < n; j += blockDim.x)
  yr[j] = expf(xr[j] - m) * inv;
'''
# the loss gradient of examples/numpy_ops.py: dx = y - onehot(label)
SOFTMAX_BWD = r'''
const int n = %(n)d;
const long long row = blockIdx.x;
const int hot = (int)label[row];
const float* yr = y + row * n;
float* dr = dx + row * n;
for (int j = threadIdx.x; j < n; j += blockDim.x)
  dr[j] = yr[j] - (j == hot ? 1.f : 0.f);
'''
# the reference MXNet's tests/python/gpu/test_rtc.py
REF_BODY = r'''
__shared__ float s_rec[10];
s_rec[threadIdx.x] = x[threadIdx.x];
y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);
'''
# tests/test_rtc.py's axpy and square as CUDA bodies: one thread per
# element, grid (rows, 1, 1) x block (columns, 1, 1)
AXPY_BODY = r'''
const int i = blockIdx.x * blockDim.x + threadIdx.x;
out[i] = 2.0f * x[i] + y[i];
'''
SQUARE_BODY = r'''
const int i = blockIdx.x * blockDim.x + threadIdx.x;
o[i] = a[i] * a[i];
'''
BROKEN_BODY = 'y[0] = x[0] +;'
SOFTMAX_RTOL = 1e-5
LM_HEAD = (8192, 32000)     # the LM's logits at 16 x 512 tokens (off-path)
CUSTOM_PARITY_ROWS = 2
_SOFTMAX_KERNELS = {}


def rtc_block(n):
    """Threads per row: 256 for the head's 1000 classes; 1024 for wider
    rows, where each thread then loops over 32 of the row's elements.
    (At (8192, 32000) the forward's second and third reads of each row
    still come from device memory, not L2: see PERF.md.)"""
    return 256 if n <= 4096 else 1024


def softmax_kernels(mx, n):
    """The (forward, backward) Rtc kernels for rows of ``n`` classes, made
    once per width."""
    k = _SOFTMAX_KERNELS.get(n)
    if k is None:
        row, lab = mx.nd.zeros((1, n)), mx.nd.zeros((1,))
        k = _SOFTMAX_KERNELS[n] = (
            mx.rtc.Rtc('softmax_fwd', [('x', row)], [('y', row)],
                       SOFTMAX_FWD % {'n': n}),
            mx.rtc.Rtc('softmax_bwd', [('y', row), ('label', lab)],
                       [('dx', row)], SOFTMAX_BWD % {'n': n}))
    return k


def push_softmax(mx, x, out):
    fwd, _ = softmax_kernels(mx, x.shape[1])
    fwd.push([x], [out], (x.shape[0], 1, 1), (rtc_block(x.shape[1]), 1, 1))


def push_softmax_grad(mx, y, label, out):
    _, bwd = softmax_kernels(mx, y.shape[1])
    bwd.push([y, label], [out], (y.shape[0], 1, 1),
             (rtc_block(y.shape[1]), 1, 1))


def register_user_ops(mx):
    """The user code of the extension phases, registered as Custom ops:
    ``softmax_rtc``, the loss head of examples/numpy_ops.py
    (need_top_grad=False; on a gpu context two Rtc kernels, on the CPU
    nd.* only, the reference's idiom), and tests/test_operator_custom.py's
    ``sqr``."""
    nd = mx.nd

    class RtcSoftmax(mx.operator.CustomOp):
        # Rtc.push swaps its result into out_data / in_grad: a 'write'
        def forward(self, is_train, req, in_data, out_data, aux):
            push_softmax(mx, in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            push_softmax_grad(mx, out_data[0], in_data[1], in_grad[0])

    class NdSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = nd.exp(x - nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - nd.one_hot(in_data[1], depth=y.shape[1]))

    @mx.operator.register('softmax_rtc')
    class SoftmaxRtcProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return RtcSoftmax() if ctx.device_type == 'gpu' else NdSoftmax()

    class Sqr(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        nd.square(in_data[0]) * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * in_data[0] * (2.0 * self.scale))

    @mx.operator.register('sqr')
    class SqrProp(mx.operator.CustomOpProp):
        contexts = []       # what create_operator was given

        def __init__(self, scale='1.0'):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            SqrProp.contexts.append(ctx)
            return Sqr(self.scale)

    return SqrProp


def custom_symbol(mx, resnet):
    """Full-width ResNet-50 v2 whose SoftmaxOutput is replaced by the
    ``softmax_rtc`` Custom head over fc1's output."""
    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=IMAGE)
    fc1 = net.get_internals()['fc1_output']
    return mx.sym.Custom(fc1, mx.sym.Variable('softmax_label'),
                         op_type='softmax_rtc', name='softmax')


def rtc_compile_stats(instrument):
    return (instrument.counter_value('rtc.compiles'),
            instrument.histogram('rtc.compile_secs').sum)


def rtc_case(torch, instrument, name, kernel, ins, outs, dims, check, plain,
             library, nbytes, ops, flush, **info):
    """One Rtc case on the card: the first push (NVRTC compile and module
    load where its dtypes are new to ``kernel``), ``check()`` of its
    outputs (-> max abs error, tolerance text), then the push, its plain
    version and the library call (None where no single PyTorch call
    computes the function) timed as the other kernels are, the host cost
    of one push (decoration, cache lookup, ctypes, the output's
    allocation) and the bound."""
    n0, s0 = rtc_compile_stats(instrument)
    t0 = time.perf_counter()
    kernel.push(ins, outs, *dims)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n1, s1 = rtc_compile_stats(instrument)
    err, tol = check()

    def push():
        kernel.push(ins, outs, *dims)

    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_FLOPS * 1e3
    return dict(name=name, **info, grid=list(dims[0]), block=list(dims[1]),
                compiles=n1 - n0, nvrtc_s=s1 - s0, first_push_s=first_s,
                max_abs_err=err, tolerance=tol,
                ms=cuda_ms(torch, push, flush),
                plain_ms=cuda_ms(torch, plain, flush),
                library_ms=(cuda_ms(torch, library, flush)
                            if library is not None else None),
                host_us=host_us(torch, push),
                bound_ms=max(byte_ms, op_ms),
                bound_by='bytes' if byte_ms >= op_ms else 'operations',
                bytes=nbytes, operations=ops)


def softmax_cases(mx, torch, instrument, rows, n, gen, flush, per_step):
    """The softmax head's two kernels at (rows, n) f32: the forward within
    rtol 1e-5 of torch.softmax in float64 cast back (and of the plain
    version, the nd.* head's arithmetic); the backward exactly y -
    onehot(label)."""
    dev = torch.device('cuda', 0)
    x = torch.randn(rows, n, generator=gen, device=dev) * 3.0
    label = torch.randint(0, n, (rows,), generator=gen,
                          device=dev).float()
    xa, la = mx.nd.NDArray(x), mx.nd.NDArray(label)
    y, dx = mx.nd.zeros((rows, n), ctx=mx.gpu(0)), \
        mx.nd.zeros((rows, n), ctx=mx.gpu(0))
    fwd, bwd = softmax_kernels(mx, n)
    dims = ((rows, 1, 1), (rtc_block(n), 1, 1))

    def plain_fwd():
        e = torch.exp(x - x.amax(1, keepdim=True))
        return e / e.sum(1, keepdim=True)

    def plain_bwd():
        return y.handle - (torch.arange(n, device=dev)[None]
                           == label.long()[:, None]).float()

    hot = label.long()[:, None]
    minus_one = torch.full((rows, 1), -1.0, device=dev)

    def library_bwd():
        return torch.scatter_add(y.handle, 1, hot, minus_one)

    def check_fwd():
        got = y.handle
        want = torch.softmax(x.double(), 1).float()
        rel = float(((got - want).abs()
                     / want.abs().clamp_min(1e-37)).max())
        plain = plain_fwd()
        rel_plain = float(((got - plain).abs()
                           / plain.abs().clamp_min(1e-37)).max())
        if not bool(torch.isfinite(got).all()) or rel > SOFTMAX_RTOL or \
                rel_plain > 2 * SOFTMAX_RTOL:
            raise AssertionError(
                'rtc softmax_fwd %s: max rel err %g vs float64 softmax, '
                '%g vs the plain version (tolerance %g, %g)'
                % ((rows, n), rel, rel_plain, SOFTMAX_RTOL,
                   2 * SOFTMAX_RTOL))
        return float((got - plain).abs().max()), \
            'rtol %g of torch.softmax in float64 (max rel err %g)' % (
                SOFTMAX_RTOL, rel)

    def check_bwd():
        want = plain_bwd()
        if not torch.equal(library_bwd(), want):
            raise AssertionError('rtc softmax_bwd %s: the library call '
                                 'computes another function' % ((rows, n),))
        if not torch.equal(dx.handle, want):
            raise AssertionError('rtc softmax_bwd %s: dx differs from y - '
                                 'onehot(label) by %g' % (
                                     (rows, n), float((dx.handle - want)
                                                      .abs().max())))
        return 0.0, 'exact'

    elems = rows * n
    cases = [
        rtc_case(torch, instrument, 'softmax_fwd', fwd, [xa], [y], dims,
                 check_fwd, plain_fwd, lambda: torch.softmax(x, 1),
                 2 * elems * 4, 7 * elems, flush, shape=[rows, n],
                 dtype='float32', launches_per_step=per_step,
                 library_call='torch.softmax'),
        rtc_case(torch, instrument, 'softmax_bwd', bwd, [y, la], [dx], dims,
                 check_bwd, plain_bwd, library_bwd, 2 * elems * 4 + rows * 4,
                 elems, flush, shape=[rows, n], dtype='float32',
                 launches_per_step=per_step,
                 library_call='torch.scatter_add(y, 1, label, -1)')]
    return cases


def rtc_kernels(mx, torch, instrument, gen, flush):
    """Phase 3c: the Rtc cases on the card, TF32 off."""
    ctx = mx.gpu(0)
    nd = mx.nd
    cases = []
    # the reference MXNet's GPU test: shared memory, expf, a 10-thread block
    x, y = nd.ones((10,), ctx=ctx), nd.zeros((10,), ctx=ctx)
    k = mx.rtc.Rtc('abc', [('x', x)], [('y', y)], REF_BODY)
    want = np.float32(np.exp(5.0))

    def check_ref():
        got = y.asnumpy()
        ulps = float(np.max(np.abs(got.astype(np.float64) - float(want))
                            / np.spacing(want)))
        if ulps > 2:
            raise AssertionError('rtc abc: expf(5x) %d ulp from exp(5)'
                                 % ulps)
        return float(np.max(np.abs(got - want))), '2 ulp (%g ulp)' % ulps

    cases.append(rtc_case(
        torch, instrument, 'abc', k, [x], [y], ((1, 1, 1), (10, 1, 1)),
        check_ref, lambda: torch.exp(x.handle * 5.0), None, 80, 20, flush,
        shape=[10], dtype='float32', launches_per_step=0))
    # tests/test_rtc.py's axpy and square; a second shape of square
    # reuses its module, float16 compiles a second one
    xa = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    ya = nd.array(np.full((3, 4), 2.0, np.float32), ctx=ctx)
    out = nd.zeros((3, 4), ctx=ctx)
    axpy = mx.rtc.Rtc('axpy', [('x', xa), ('y', ya)], [('out', out)],
                      AXPY_BODY)

    def check_axpy():
        want = 2.0 * xa.asnumpy() + ya.asnumpy()
        if not np.array_equal(out.asnumpy(), want):
            raise AssertionError('rtc axpy disagrees: %s' % out.asnumpy())
        return 0.0, 'exact'

    cases.append(rtc_case(
        torch, instrument, 'axpy', axpy, [xa, ya], [out],
        ((3, 1, 1), (4, 1, 1)), check_axpy,
        lambda: 2.0 * xa.handle + ya.handle,
        lambda: torch.add(ya.handle, xa.handle, alpha=2.0), 144, 24, flush,
        shape=[3, 4], dtype='float32', launches_per_step=0,
        library_call='torch.add(y, x, alpha=2)'))
    sq = mx.rtc.Rtc('square', [('a', xa)], [('o', out)], SQUARE_BODY)
    for shape, dt in (((3, 4), 'float32'), ((2, 3), 'float32'),
                      ((2, 3), 'float16')):
        a = nd.array(np.arange(np.prod(shape)).reshape(shape), ctx=ctx,
                     dtype=dt)
        o = nd.zeros(shape, ctx=ctx, dtype=dt)

        def check_sq(a=a, o=o):
            if not torch.equal(o.handle, a.handle * a.handle):
                raise AssertionError('rtc square %s %s disagrees'
                                     % (a.shape, a.dtype))
            return 0.0, 'exact'

        case = rtc_case(
            torch, instrument, 'square', sq, [a], [o],
            ((shape[0], 1, 1), (shape[1], 1, 1)), check_sq,
            lambda a=a: a.handle * a.handle,
            lambda a=a: torch.square(a.handle), 2 * a.size * a.handle
            .element_size(), a.size, flush, shape=list(shape), dtype=dt,
            launches_per_step=0, library_call='torch.square')
        cases.append(case)
    new = [c['compiles'] for c in cases if c['name'] == 'square']
    if new != [1, 0, 1] or len(sq._cache) != 2:
        raise AssertionError('rtc square: compiles per push %s (want one per '
                             'dtype, none for a new shape), %d modules'
                             % (new, len(sq._cache)))
    # path 4's head at its shape, then at the LM head's (off the path)
    cases += softmax_cases(mx, torch, instrument, BATCH, 1000, gen, flush, 1)
    cases += softmax_cases(mx, torch, instrument, LM_HEAD[0], LM_HEAD[1],
                           gen, flush, 0)
    # a syntax error raises with NVRTC's log
    bad = mx.rtc.Rtc('broken', [('x', x)], [('y', y)], BROKEN_BODY)
    try:
        bad.push([x], [nd.zeros((10,), ctx=ctx)])
    except mx.MXNetError as e:
        if 'expected an expression' not in str(e):
            raise AssertionError('rtc: compile error without the log: %s'
                                 % e) from e
        bad_log = str(e)
    else:
        raise AssertionError('rtc: a body with a syntax error compiled')
    for kernel in (k, axpy, sq):
        kernel.close()
    return cases, bad_log


def rtc_summary(cases, launches):
    """The kernels-line entry of Rtc: the head's two launches of one
    32-row training step (forward and backward, float32)."""
    on_path = [c for c in cases if c['launches_per_step']]
    modules = [c for c in cases if c['compiles']]
    return {'name': 'rtc', 'route': 'cuda',
            'source': 'mxnet_tpu_torch/csrc/rtc.cu',
            'replaces': 'mxnet_tpu/rtc.py:91', 'launches': launches,
            'launches_by_path': {'custom-train': launches},
            'kernel_bodies': 'chip_smoke.py SOFTMAX_FWD, SOFTMAX_BWD',
            'max_abs_err': max(c['max_abs_err'] for c in on_path),
            'ms': _sum_cases(on_path, 'ms'),
            'plain_ms': _sum_cases(on_path, 'plain_ms'),
            'bound_ms': _sum_cases(on_path, 'bound_ms'),
            'bound_by': 'bytes',
            'library_ms': _sum_cases(on_path, 'library_ms'),
            'library_call': 'torch.softmax (forward) + torch.scatter_add '
                            '(backward)',
            'per': 'one 32-row training step (softmax forward and '
                   'backward), float32',
            'host_us_per_push': statistics.mean(c['host_us']
                                                for c in on_path),
            'nvrtc_s_per_module': statistics.mean(
                c['nvrtc_s'] / c['compiles'] for c in modules),
            'cases': cases}


def imperative_script(mx, data):
    """A fixed script of nd.* calls on the current context: one op of each
    family of the imperative layer, NDArray arithmetic, indexing and
    in-place updates, and nd.Custom.  Returns [(name, result, exact)]."""
    nd = mx.nd
    a, b = nd.array(data['a']), nd.array(data['b'])     # (3, 4)
    i, j = nd.array(data['i']), nd.array(data['j'])     # integer-valued
    r = nd.array(data['row'])                            # (1, 4)
    idx = nd.array(data['idx'])                          # (3,) in [0, 4)
    m3 = nd.array(data['m3'])                            # (2, 3, 4)
    c = a.copy()
    c[1, 1:3] = 7.0
    c[0] = b[2]
    d = a.copy()
    d += b
    d *= 2.0
    e = nd.zeros((3, 4))
    nd.relu(b, out=e)
    top_v, top_i = nd.topk(i, k=2, ret_typ='both')
    return [
        ('exp', nd.exp(a), False), ('relu', nd.relu(a), True),
        ('stop_gradient', nd.stop_gradient(a), True),
        ('Cast', nd.Cast(a * 10, dtype='int32'), True),
        ('_plus', nd._plus(a, b), True),
        ('broadcast_mul', nd.broadcast_mul(a, r), True),
        ('div', a / b, False), ('mod', a % 1.5, False),
        ('scalar', 2.0 - a * 3.0, True), ('power_scalar', a ** 2, False),
        ('greater', i > j, True),
        ('smooth_l1', nd.smooth_l1(a, scalar=0.7), False),
        ('broadcast_to', nd.broadcast_to(r, shape=(3, 4)), True),
        ('broadcast_axis', nd.broadcast_axis(nd.expand_dims(idx, axis=1),
                                             axis=1, size=4), True),
        ('sum', nd.sum(m3, axis=(0, 2), keepdims=True), False),
        ('mean', nd.mean(m3, axis=1), False),
        ('max', nd.max(i, axis=1), True),
        ('argmax', nd.argmax(i, axis=1), True),
        ('norm', nd.norm(a), False),
        ('expand_dims', nd.expand_dims(a, axis=0), True),
        ('dot', nd.dot(a, b, transpose_b=True), False),
        ('batch_dot', nd.batch_dot(m3, m3, transpose_b=True), False),
        ('slice', nd.slice(m3, begin=(0, 1, None), end=(2, 3, -1)), True),
        ('setitem', c, True), ('getitem', a[1:3], True),
        ('_crop_assign_scalar', nd._crop_assign_scalar(
            a, begin=(0, 1), end=(2, 3), scalar=5.0), True),
        ('flip', nd.flip(a, axis=1), True),
        ('repeat', nd.repeat(a, repeats=2, axis=0), True),
        ('tile', nd.tile(a, reps=(2, 1)), True),
        ('pad', nd.pad(m3.reshape((1, 2, 3, 4)), mode='constant',
                       pad_width=(0, 0, 0, 0, 1, 1, 2, 2),
                       constant_value=1.5), True),
        ('take', nd.take(a, idx, axis=1), True),
        ('batch_take', nd.batch_take(a, idx), True),
        ('one_hot', nd.one_hot(idx, depth=4), True),
        ('where', nd.where(i > 0, a, b), True),
        ('_ones', nd._ones(shape=(2, 3)), True),
        ('_full', nd._full(shape=(2, 3), value=2.5), True),
        ('_arange', nd._arange(start=1.0, stop=9.0, step=2.0, repeat=2),
         True),
        ('arange', nd.arange(0, 6), True),
        ('zeros_like', nd.zeros_like(a), True),
        ('topk_value', top_v, True), ('topk_index', top_i, True),
        ('sort', nd.sort(i, axis=1), True),
        ('argsort', nd.argsort(i, axis=1), True),
        ('add_n', nd.add_n(a, b, a), False),
        ('reciprocal', nd.reciprocal(b), False),
        ('trunc', nd.trunc(a * 3), True),
        ('diag', nd.diag(i[:, :3], k=1), True),
        ('stack', nd.stack(a, b, axis=1), True),
        ('pick', nd.pick(a, idx, axis=1), True),
        ('softmax', nd.softmax(a, axis=1), False),
        ('SoftmaxActivation', nd.SoftmaxActivation(a), False),
        ('LeakyReLU', nd.LeakyReLU(a, slope=0.1), True),
        ('Dropout_p0', nd.Dropout(a, p=0.0), True),
        ('Concat', nd.Concat(a, b, dim=1), True),
        ('inplace', d, True), ('out', e, True),
        ('maximum', nd.maximum(a, b), True),
        ('power', nd.power(2.0, a), False),
        ('Custom', nd.Custom(a, op_type='sqr', scale=3), True)]


def imperative_data():
    rs = np.random.RandomState(SEED)
    return {'a': rs.randn(3, 4).astype(np.float32),
            'b': (rs.rand(3, 4) + 0.5).astype(np.float32),
            'i': rs.randint(-3, 3, (3, 4)).astype(np.float32),
            'j': rs.randint(-3, 3, (3, 4)).astype(np.float32),
            'row': rs.randn(1, 4).astype(np.float32),
            'idx': rs.randint(0, 4, (3,)).astype(np.float32),
            'm3': rs.randn(2, 3, 4).astype(np.float32)}


def random_moments(mx):
    """mx.random on the current context: moments of 10^5 draws (the
    bounds of tests/test_random.py), seed determinism, and Dropout's kept
    share."""
    mx.random.seed(SEED)
    u = mx.random.uniform(-2.0, 3.0, shape=(100000,))
    n = mx.random.normal(1.0, 2.0, shape=(100000,))
    mx.random.seed(SEED)
    again = mx.random.uniform(-2.0, 3.0, shape=(100000,))
    kept = float((mx.nd.Dropout(mx.nd.ones((100, 100)), p=0.3)
                  .asnumpy() != 0).mean())
    uv, nv = u.asnumpy(), n.asnumpy()
    res = {'device': str(u.context), 'uniform_min': float(uv.min()),
           'uniform_max': float(uv.max()), 'uniform_mean': float(uv.mean()),
           'normal_mean': float(nv.mean()), 'normal_std': float(nv.std()),
           'seed_repeats': bool(np.array_equal(uv, again.asnumpy())),
           'dropout_kept': kept}
    if not (uv.min() >= -2.0 and uv.max() <= 3.0
            and abs(uv.mean() - 0.5) < 0.05 and abs(nv.mean() - 1.0) < 0.05
            and abs(nv.std() - 2.0) < 0.05 and res['seed_repeats']
            and abs(kept - 0.7) < 0.03):
        raise AssertionError('mx.random moments off: %s' % res)
    return res


def imperative(mx, sqr_prop):
    """Phase 10: the script under ``with mx.gpu(0):`` and on ``cpu()``
    from the same numpy inputs: rtol 1e-5 (atol 1e-6), exact for integer,
    indexing and data-movement ops; every result on its scope's
    context."""
    data = imperative_data()
    # outside a scope: nd.array / nd.zeros on the host, the rest on the card
    placed = [mx.nd.array([1.0]).context, mx.nd.zeros((1,)).context,
              mx.nd.ones((1,)).context, mx.nd.arange(2).context,
              mx.random.uniform(shape=(2,)).context]
    if placed != [mx.cpu(0)] * 2 + [mx.gpu(0)] * 3:
        raise AssertionError('imperative: default contexts %s' % placed)
    runs, moments = {}, {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            del sqr_prop.contexts[:]
            res = imperative_script(mx, data)
            moments[ctx.device_type] = random_moments(mx)
        wrong = [name for name, v, _ in res if v.context != ctx]
        if wrong or sqr_prop.contexts != [ctx]:
            raise AssertionError('imperative: %s ran off %s (Custom got %s)'
                                 % (wrong, ctx, sqr_prop.contexts))
        runs[ctx.device_type] = [(name, v.asnumpy(), exact)
                                 for name, v, exact in res]
    worst = (0.0, None)
    for (name, g, exact), (_, h, _) in zip(runs['gpu'], runs['cpu']):
        if g.dtype != h.dtype or g.shape != h.shape:
            raise AssertionError('imperative %s: %s %s on the card, %s %s '
                                 'on the CPU' % (name, g.dtype, g.shape,
                                                 h.dtype, h.shape))
        if exact:
            np.testing.assert_array_equal(g, h, err_msg=name)
        else:
            np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            err = float(np.max(np.abs(g.astype(np.float64) - h)))
            if err > worst[0]:
                worst = (err, name)
    return {'calls': len(runs['gpu']),
            'exact': sum(1 for r in runs['gpu'] if r[2]),
            'max_abs_err_float': worst[0], 'worst': worst[1],
            'tolerance': 'rtol 1e-5, atol 1e-6; exact for integer, '
                         'indexing and data-movement ops',
            'random': moments}


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this smoke test runs on the GPU',
              file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import convert, instrument, models
        from mxnet_tpu_torch.ops import _kernels, attention, fused, fused_conv
        from mxnet_tpu_torch.models import resnet
        from mxnet_tpu_torch.parallel import train_step as ts
    except ImportError as e:
        print('chip_smoke: the mxnet_tpu_torch package is missing (%s); run '
              'from the root of a checkout' % e, file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'
    sqr_prop = register_user_ops(mx)

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log({'phase': 'device', 'kind': kind, 'count': torch.cuda.device_count(),
         'nvidia_smi': smi, 'torch': torch.__version__,
         'cuda': torch.version.cuda, 'python': sys.version.split()[0]})

    # -- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    _kernels.build()
    ptxas = {n: [ln.strip() for ln in log_.splitlines()
                 if 'registers' in ln or 'spill' in ln]
             for n, log_ in _kernels.build_logs.items()}
    log({'phase': 'build', 'seconds': time.monotonic() - t0,
         'nvcc_seconds': _kernels.build_seconds, 'ptxas': ptxas})

    # -- 3. kernels: each against its plain version ------------------------
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    path = bn_relu_shapes(mx, symbol, BATCH)
    if sum(path.values()) != 17:
        raise AssertionError('expected 17 BN-ReLU nodes on the ResNet-50 '
                             'inference path, found %s' % dict(path))
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    flush = torch.ones(32 << 20, device='cuda')    # 128 MiB
    cases = []
    for shape, per_forward in sorted(path.items()):
        case = check_bn_relu(torch, fused, shape, torch.float32, gen, flush)
        case['launches_per_forward'] = per_forward
        cases.append(case)
    # off the path: a ragged bf16 shape (odd sizes, numel not a multiple
    # of the 8-wide vector) and an unaligned view (scalar path)
    ragged = check_bn_relu(torch, fused, (3, 37, 7, 5), torch.bfloat16, gen,
                           flush)
    ragged['launches_per_forward'] = 0
    cases.append(ragged)
    base = torch.randn(1 + 2 * 64 * 9, generator=gen, device='cuda')
    xu = base[1:].view(2, 64, 3, 3)
    su, bu = torch.ones(64, device='cuda'), torch.zeros(64, device='cuda')
    if not torch.equal(fused.fused_bn_relu(xu, su, bu),
                       fused.fused_bn_relu_plain(xu, su, bu)):
        raise AssertionError('fused_bn_relu: unaligned view disagrees')
    # the training path, read from the aggressive training graph
    dots, convs, train_bn_relus = train_kernel_shapes(mx, symbol, BATCH)
    if sum(dots.values()) != 36 or sum(convs.values()) != 16:
        raise AssertionError('expected 36 1x1 and 16 3x3 _bn_relu_conv '
                             'nodes in ResNet-50 v2 training, found %s / %s'
                             % (dict(dots), dict(convs)))
    for shape, per_step in sorted(train_bn_relus.items()):
        case = check_bn_relu(torch, fused, shape, torch.bfloat16, gen, flush)
        case['launches_per_forward'] = 0
        case['launches_per_step'] = per_step
        cases.append(case)
    # TF32 off: the f32 plain versions and library calls are full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dot_cases, conv_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for mkn, per_step in sorted(dots.items()):
            case = check_dot(torch, fused, mkn, dtype, gen, flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('fused_scale_bias_dot %s %s took the '
                                     '%s route' % (mkn, case['dtype'],
                                                   case['route']))
            case['launches_per_step'] = per_step
            dot_cases.append(case)
        for shape, per_step in sorted(convs.items()):
            case = check_conv(torch, fused_conv, shape, dtype, gen, flush)
            case['launches_per_step'] = per_step
            conv_cases.append(case)
        # off the path: a ragged dot (no tile divides M, K or N) and an
        # odd-H/W stride-2 conv
        case = check_dot(torch, fused, (1001, 37, 130), dtype, gen, flush)
        case['launches_per_step'] = 0
        dot_cases.append(case)
        case = check_conv(torch, fused_conv, (3, 15, 13, 24, 40, 2), dtype,
                          gen, flush)
        case['launches_per_step'] = 0
        conv_cases.append(case)
    # the sm90 route off the path: K = 72 (a second, padded K step) with a
    # positive bias and NaN past K in scale and bias, ragged M; the ragged
    # N tile at BN 64; a NaN row
    for mkn, kw in (((1001, 72, 256), {'positive_bias': True}),
                    ((256, 96, 72), {}),
                    ((1001, 64, 256), {'nan_row': 500})):
        case = check_dot(torch, fused, mkn, torch.bfloat16, gen, flush, **kw)
        if case['route'] != 'sm90':
            raise AssertionError('fused_scale_bias_dot %s took the %s route'
                                 % (mkn, case['route']))
        case['launches_per_step'] = 0
        dot_cases.append(case)
    dot_layouts = check_dot_layouts(torch, fused, (25088, 128, 512), gen)
    torch.backends.cudnn.allow_tf32 = True
    log({'phase': 'kernels', 'cases': cases, 'dot_cases': dot_cases,
         'dot_w_layouts': dot_layouts, 'conv_cases': conv_cases,
         'tf32': False})
    att_cases, epi_cases = lm_kernels(mx, torch, attention, fused, models,
                                      gen, flush)
    log({'phase': 'lm-kernels', 'flash_attention_cases': att_cases,
         'fused_dot_epilogue_cases': epi_cases, 'tf32': False})
    rtc_cases, bad_log = rtc_kernels(mx, torch, instrument, gen, flush)
    del flush
    compiles = instrument.histogram('rtc.compile_secs')
    log({'phase': 'rtc-kernels', 'cases': rtc_cases, 'tf32': False,
         'nvrtc_modules': compiles.count,
         'nvrtc_s_per_module': compiles.sum / max(compiles.count, 1),
         'compile_error_log': bad_log})

    # -- 4. serve: the main path ---------------------------------------------
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                      SEED)
    params = convert.params_from_numpy(arg, aux, 'cuda:0')
    server = mx.serving.ModelServer(max_delay_ms=2.0, max_batch=BATCH)
    rng = np.random.default_rng(SEED + 1)
    data = rng.standard_normal((64,) + IMAGE, dtype=np.float32)
    try:
        t0 = time.monotonic()
        server.load_model('resnet50', symbol_json=symbol.tojson(),
                          params=params, input_shapes={'data': (BATCH,)
                                                       + IMAGE})
        load_s = time.monotonic() - t0
        # one request per pow2 bucket first: each bucket's first forward
        # pays cuDNN's algorithm setup, which the measured run should not
        t0 = time.monotonic()
        b = 1
        while b <= BATCH:
            server.predict('resnet50', timeout=300, data=data[:b])
            b *= 2
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        instrument.reset_metrics()
        reset_launches(fused.fused_bn_relu)
        fwd0 = instrument.counter_value('executor.forwards')
        results, wall = serve(server, data, rng)
        torch.cuda.synchronize()
        launches = {'fused_bn_relu': fused.fused_bn_relu.launches}
        forwards = instrument.counter_value('executor.forwards') - fwd0
        for name, n in launches.items():
            if n == 0:
                raise AssertionError('kernel %s never launched on the main '
                                     'path' % name)
        if launches['fused_bn_relu'] != 17 * forwards:
            raise AssertionError('fused_bn_relu launched %d times in %d '
                                 'forwards (expected 17 each)'
                                 % (launches['fused_bn_relu'], forwards))
        for rows, _, out in results:
            if out.shape != (rows, 1000) or not np.all(np.isfinite(out)) \
                    or not np.allclose(out.sum(axis=1), 1.0, atol=1e-4):
                raise AssertionError('bad response: shape %s' % (out.shape,))
        lat = np.array([r[1] for r in results])
        rows_total = sum(r[0] for r in results)
        hist = instrument.histogram('serving.e2e_secs')
        log({'phase': 'serve', 'model': 'resnet-50 v2', 'classes': 1000,
             'image': list(IMAGE), 'max_batch': BATCH, 'fuse': 'aggressive',
             'tf32_conv': torch.backends.cudnn.allow_tf32,
             'load_s': load_s, 'warmup_s': warm_s,
             'requests': len(results), 'rows': rows_total,
             'forwards': forwards, 'launches': launches,
             'wall_s': wall, 'images_per_s': rows_total / wall,
             'p50_ms': float(np.percentile(lat, 50)) * 1e3,
             'p99_ms': float(np.percentile(lat, 99)) * 1e3,
             'server_e2e_p50_ms': hist.quantile(0.5) * 1e3,
             'server_e2e_p99_ms': hist.quantile(0.99) * 1e3,
             'flushes': instrument.counter_value('serving.flushes')})

        # -- 5. parity against the CPU, TF32 off ---------------------------
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = data[:4]
        card = server.predict('resnet50', timeout=300, data=rows)[0]
    finally:
        server.close()
    cpu_pred = mx.Predictor(symbol.tojson(),
                            convert.params_from_numpy(arg, aux, 'cpu'),
                            {'data': (4,) + IMAGE}, dev_type='cpu')
    cpu_pred.forward(data=rows)
    ref = cpu_pred.get_output(0)
    rel = float(np.max(np.abs(card - ref) / np.maximum(np.abs(ref), 1e-30)))
    top1 = bool(np.array_equal(card.argmax(1), ref.argmax(1)))
    log({'phase': 'parity', 'rows': 4, 'tf32': False, 'max_rel_err': rel,
         'max_abs_err': float(np.max(np.abs(card - ref))),
         'top1_equal': top1})
    np.testing.assert_allclose(card, ref, rtol=1e-3, atol=1e-7)
    if not top1:
        raise AssertionError('top-1 differs between the card and the CPU')

    # -- 6. train: the second main path ----------------------------------
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    bn_relu_nodes = sum(1 for n in prog.topo_nodes() if n.op == '_bn_relu')
    rng = np.random.default_rng(SEED + 2)
    images = rng.standard_normal((TRAIN_BATCHES * BATCH,) + IMAGE,
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, TRAIN_BATCHES * BATCH).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (fused.fused_bn_relu, fused.fused_scale_bias_dot,
              fused_conv.fused_scale_bias_conv3x3):
        reset_launches(k)
    t0 = time.monotonic()
    mod, step_s = train_module(mx, torch, symbol, arg, aux, images, labels,
                               mx.gpu(0), torch.bfloat16, BATCH)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    train_launches = {
        'fused_scale_bias_dot': fused.fused_scale_bias_dot.launches,
        'fused_scale_bias_conv3x3':
            fused_conv.fused_scale_bias_conv3x3.launches,
        'fused_bn_relu': fused.fused_bn_relu.launches}
    expected = {'fused_scale_bias_dot': 36, 'fused_scale_bias_conv3x3': 16,
                'fused_bn_relu': bn_relu_nodes}
    steps = len(step_s)
    for name, per_step in expected.items():
        if train_launches[name] != per_step * steps or steps != \
                TRAIN_BATCHES:
            raise AssertionError('%s launched %d times in %d training steps '
                                 '(expected %d each)'
                                 % (name, train_launches[name], steps,
                                    per_step))
    train_routes = dict(fused.fused_scale_bias_dot.launches_by_route)
    if train_routes['sm90'] != 36 * steps:
        raise AssertionError('fused_scale_bias_dot took the sm90 route %d '
                             'times of %d in %d steps: %s'
                             % (train_routes['sm90'], 36 * steps, steps,
                                train_routes))
    metric = dict(mod._fused_metric.get_name_value())
    trained, trained_aux = mod.get_params()
    moved = 0.0
    for k, v in arg.items():
        t = trained[k].asnumpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('parameter %s is not finite' % k)
        moved = max(moved, float(np.max(np.abs(t - v))))
    if not all(np.all(np.isfinite(v.asnumpy()))
               for v in trained_aux.values()):
        raise AssertionError('a BatchNorm moving statistic is not finite')
    if not np.isfinite(metric['cross-entropy']) or moved <= 0.0:
        raise AssertionError('training did not move: loss %s, max |dw| %g'
                             % (metric['cross-entropy'], moved))
    step_ms = statistics.median(step_s[TRAIN_WARMUP:]) * 1e3
    log({'phase': 'train', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'batch': BATCH, 'steps': steps,
         'compute_dtype': 'bfloat16', 'fuse': 'aggressive',
         'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
         'launches': train_launches, 'launches_per_step': expected,
         'fused_scale_bias_dot_launches_by_route': train_routes,
         'fit_s': fit_s, 'step_ms': [t * 1e3 for t in step_s],
         'step_ms_median_after_warmup': step_ms,
         'images_per_s': BATCH / step_ms * 1e3,
         'peak_memory_bytes': torch.cuda.max_memory_allocated(),
         'train_cross_entropy': metric['cross-entropy'],
         'train_accuracy': metric['accuracy'], 'max_param_change': moved})
    del mod, trained, trained_aux

    # -- 7. train-parity: one f32 step on the card and on the CPU ----------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p_images, p_labels = images[:PARITY_ROWS], labels[:PARITY_ROWS]
    stepped = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.monotonic()
        pmod, _ = train_module(mx, torch, symbol, arg, aux, p_images,
                               p_labels, ctx, None, PARITY_ROWS)
        stepped[ctx.device_type] = ({k: v.asnumpy() for k, v in
                                     pmod.get_params()[0].items()},
                                    time.monotonic() - t0)
        del pmod
    (card, card_s), (host, cpu_s) = stepped['gpu'], stepped['cpu']
    # the relu-kink bound of param_parity; every parameter that differs
    # is reported
    n_out, total, worst, outside = param_parity(card, host)
    log({'phase': 'train-parity', 'rows': PARITY_ROWS, 'dtype': 'float32',
         'tf32': False, 'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; '
         'at most 1e-4 of the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('train-parity: %d of %d parameter elements '
                             'beyond rtol 1e-3, atol 1e-5, max abs err %g '
                             'in %s' % (n_out, total, worst[0], worst[1]))

    # -- 8. lm-train: the third main path ----------------------------------
    dev = torch.device('cuda', 0)
    lm_sym = lm_symbol(models)
    seq = LM['seq_len']
    lm_arg, _ = convert.random_params(
        lm_sym, {'data': (LM_BATCH, seq), 'softmax_label': (LM_BATCH, seq)},
        SEED, init='normal')
    params = {k: torch.from_numpy(v).to(dev) for k, v in lm_arg.items()}
    opt_state = ts.sgd_momentum_init(params)
    batch = lm_batch(torch, dev, LM_BATCH)
    step = lm_step(ts, lm_sym, LM_BATCH, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(attention.flash_attention)
    reset_launches(fused.fused_dot_epilogue)
    lm_step_s, ce = [], []
    t0 = time.monotonic()
    for i in range(LM_STEPS):
        t1 = time.perf_counter()
        outs, params, _, opt_state = step(params, {}, opt_state, batch)
        torch.cuda.synchronize()
        lm_step_s.append(time.perf_counter() - t1)
        if i in (0, LM_STEPS - 1):
            ce.append(cross_entropy(torch, outs[0], batch['softmax_label']))
    lm_s = time.monotonic() - t0
    lm_launches = {'flash_attention': attention.flash_attention.launches,
                   'fused_dot_epilogue': fused.fused_dot_epilogue.launches}
    for name, n in lm_launches.items():
        if n != LM['num_layers'] * LM_STEPS:
            raise AssertionError('%s launched %d times in %d LM steps '
                                 '(expected %d each)' % (
                                     name, n, LM_STEPS, LM['num_layers']))
    lm_routes = dict(fused.fused_dot_epilogue.launches_by_route)
    if lm_routes['sm90'] != LM['num_layers'] * LM_STEPS:
        raise AssertionError('fused_dot_epilogue took the sm90 route %d '
                             'times of %d in %d LM steps: %s'
                             % (lm_routes['sm90'], LM['num_layers']
                                * LM_STEPS, LM_STEPS, lm_routes))
    if tuple(outs[0].shape) != (LM_BATCH * seq, LM['vocab_size']) or \
            not bool(torch.isfinite(outs[0].float()).all()) or \
            not all(np.isfinite(ce)):
        raise AssertionError('lm-train: bad output %s, cross-entropy %s'
                             % (tuple(outs[0].shape), ce))
    lm_moved = 0.0
    for k, v in lm_arg.items():
        t = params[k].cpu().numpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('LM parameter %s is not finite' % k)
        lm_moved = max(lm_moved, float(np.max(np.abs(t - v))))
    if lm_moved <= 0.0:
        raise AssertionError('lm-train: the parameters did not move')
    lm_ms = statistics.median(lm_step_s[TRAIN_WARMUP:]) * 1e3
    log({'phase': 'lm-train', 'model': 'transformer_lm', **LM,
         'batch': LM_BATCH, 'steps': LM_STEPS, 'compute_dtype': 'bfloat16',
         'fuse': 'aggressive', 'entry': 'parallel.make_train_step',
         'optimizer': 'sgd lr 0.01 momentum 0.9 wd 0 rescale 1/%d'
                      % (LM_BATCH * seq),
         'launches': lm_launches,
         'launches_per_step': {k: LM['num_layers'] for k in lm_launches},
         'fused_dot_epilogue_launches_by_route': lm_routes,
         'wall_s': lm_s, 'step_ms': [t * 1e3 for t in lm_step_s],
         'step_ms_median_after_warmup': lm_ms,
         'tokens_per_s': LM_BATCH * seq / lm_ms * 1e3,
         'peak_memory_bytes': torch.cuda.max_memory_allocated(),
         'cross_entropy_first_last': ce,
         'ln_vocab': float(np.log(LM['vocab_size'])),
         'max_param_change': lm_moved})
    del params, opt_state, outs, step

    # -- 9. lm-parity: one f32 LM step on the card and on the CPU ----------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stepped = {}
    for d in (dev, torch.device('cpu')):
        t0 = time.monotonic()
        # copies: the step updates in place, and on the CPU
        # torch.from_numpy(...).to(d) would share lm_arg's memory
        p = {k: torch.tensor(v, device=d) for k, v in lm_arg.items()}
        _, p, _, _ = lm_step(ts, lm_sym, LM_PARITY_ROWS, None)(
            p, {}, ts.sgd_momentum_init(p),
            lm_batch(torch, d, LM_PARITY_ROWS))
        stepped[d.type] = ({k: v.cpu().numpy() for k, v in p.items()},
                           time.monotonic() - t0)
        del p
    (card, card_s), (host, cpu_s) = stepped['cuda'], stepped['cpu']
    n_out, total, worst, outside = param_parity(card, host)
    # the update itself is small against N(0, 0.02) weights (many
    # elements move by less than their float32 spacing): the largest
    # difference is reported against the largest update as well
    max_update = max(float(np.max(np.abs(host[k] - lm_arg[k])))
                     for k in host)
    log({'phase': 'lm-parity', 'rows': LM_PARITY_ROWS, 'seq_len': seq,
         'dtype': 'float32', 'tf32': False,
         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 of '
         'the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'max_update': max_update,
         'max_abs_err_over_max_update': worst[0] / max_update,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('lm-parity: %d of %d parameter elements beyond '
                             'rtol 1e-3, atol 1e-5, max abs err %g in %s'
                             % (n_out, total, worst[0], worst[1]))

    # -- 10. imperative: nd.* on the card and on the CPU ------------------
    log({'phase': 'imperative', **imperative(mx, sqr_prop)})

    # -- 11. custom-train: the fourth main path ----------------------------
    csym = custom_symbol(mx, resnet)
    dots, convs, bn_relus = train_kernel_shapes(mx, csym, BATCH)
    expected = {'fused_scale_bias_dot': sum(dots.values()),
                'fused_scale_bias_conv3x3': sum(convs.values()),
                'fused_bn_relu': sum(bn_relus.values()), 'rtc': 2}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (fused.fused_bn_relu, fused.fused_scale_bias_dot,
              fused_conv.fused_scale_bias_conv3x3, mx.rtc.Rtc):
        reset_launches(k)
    t0 = time.monotonic()
    mod, step_s = train_module(mx, torch, csym, arg, aux, images, labels,
                               mx.gpu(0), None, BATCH)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    custom_launches = {
        'fused_scale_bias_dot': fused.fused_scale_bias_dot.launches,
        'fused_scale_bias_conv3x3':
            fused_conv.fused_scale_bias_conv3x3.launches,
        'fused_bn_relu': fused.fused_bn_relu.launches,
        'rtc': mx.rtc.Rtc.launches}
    steps = len(step_s)
    for name, per_step in expected.items():
        if custom_launches[name] != per_step * steps or steps != \
                TRAIN_BATCHES:
            raise AssertionError('custom-train: %s launched %d times in %d '
                                 'steps (expected %d each)'
                                 % (name, custom_launches[name], steps,
                                    per_step))
    # float32 keeps the SIMT route
    custom_routes = dict(fused.fused_scale_bias_dot.launches_by_route)
    if custom_routes['simt'] != custom_launches['fused_scale_bias_dot']:
        raise AssertionError('custom-train: fused_scale_bias_dot routes %s'
                             % custom_routes)
    metric = dict(mod._fused_metric.get_name_value())
    trained = mod.get_params()[0]
    moved = 0.0
    for k, v in arg.items():
        t = trained[k].asnumpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('custom-train: parameter %s is not finite'
                                 % k)
        moved = max(moved, float(np.max(np.abs(t - v))))
    if not np.isfinite(metric['cross-entropy']) or moved <= 0.0:
        raise AssertionError('custom-train did not move: loss %s, max |dw| '
                             '%g' % (metric['cross-entropy'], moved))
    step_ms = statistics.median(step_s[TRAIN_WARMUP:]) * 1e3
    log({'phase': 'custom-train', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'batch': BATCH, 'steps': steps,
         'head': 'Custom softmax_rtc (Rtc softmax_fwd / softmax_bwd)',
         'compute_dtype': 'float32', 'fuse': 'aggressive',
         'tf32_conv': torch.backends.cudnn.allow_tf32,
         'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
         'launches': custom_launches, 'launches_per_step': expected,
         'fused_scale_bias_dot_launches_by_route': custom_routes,
         'fit_s': fit_s, 'step_ms': [t * 1e3 for t in step_s],
         'step_ms_median_after_warmup': step_ms,
         'images_per_s': BATCH / step_ms * 1e3,
         'peak_memory_bytes': torch.cuda.max_memory_allocated(),
         'train_cross_entropy': metric['cross-entropy'],
         'train_accuracy': metric['accuracy'], 'max_param_change': moved})
    del mod, trained

    # -- 12. custom-parity: one f32 step, Rtc head vs nd.* head ------------
    stepped = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.monotonic()
        pmod, _ = train_module(mx, torch, csym, arg, aux,
                               images[:CUSTOM_PARITY_ROWS],
                               labels[:CUSTOM_PARITY_ROWS], ctx, None,
                               CUSTOM_PARITY_ROWS)
        stepped[ctx.device_type] = ({k: v.asnumpy() for k, v in
                                     pmod.get_params()[0].items()},
                                    time.monotonic() - t0)
        del pmod
    (card, card_s), (host, cpu_s) = stepped['gpu'], stepped['cpu']
    n_out, total, worst, outside = param_parity(card, host)
    log({'phase': 'custom-parity', 'rows': CUSTOM_PARITY_ROWS,
         'dtype': 'float32', 'tf32': False,
         'heads': 'Rtc on the card, nd.* on the CPU',
         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 of '
         'the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('custom-parity: %d of %d parameter elements '
                             'beyond rtol 1e-3, atol 1e-5, max abs err %g '
                             'in %s' % (n_out, total, worst[0], worst[1]))

    # -- summary -------------------------------------------------------------
    on_path = [c for c in cases if c['launches_per_forward']]
    summary = {
        'name': 'fused_bn_relu', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/csrc/fused_bn_relu.cu',
        'replaces': 'mxnet_tpu/ops/pallas_fused.py:196',
        'launches': launches['fused_bn_relu']
        + train_launches['fused_bn_relu'],
        'launches_by_path': {'serve': launches['fused_bn_relu'],
                             'train': train_launches['fused_bn_relu']},
        'max_abs_err': max(c['max_abs_err'] for c in on_path),
        # the 17 launches of one 32-row forward: per-shape medians summed
        'ms': sum(c['ms'] * c['launches_per_forward'] for c in on_path),
        'plain_ms': sum(c['plain_ms'] * c['launches_per_forward']
                        for c in on_path),
        'bound_ms': sum(c['bound_ms'] * c['launches_per_forward']
                        for c in on_path),
        'bound_by': ('bytes' if all(c['bound_by'] == 'bytes'
                               for c in on_path) else 'operations'),
        'library_ms': None,
        'per': 'one 32-row serving forward, float32',
        'train_ms': sum(c['ms'] * c.get('launches_per_step', 0)
                        for c in cases),
        'train_bound_ms': sum(c['bound_ms'] * c.get('launches_per_step', 0)
                              for c in cases),
        'cases': cases}
    lm_per = 'one %d-row LM training step forward, bfloat16' % LM_BATCH
    kernels = [
        summary,
        {**gemm_summary('fused_scale_bias_dot', 'mxnet_tpu_torch/csrc/'
                        'fused_scale_bias_dot.cu',
                        'mxnet_tpu/ops/pallas_fused.py:72', dot_cases,
                        {'train': train_launches['fused_scale_bias_dot']},
                        'torch.matmul on the normalized input'),
         **route_summary(dot_cases, {'train': train_routes,
                                     'custom-train': custom_routes})},
        gemm_summary('fused_scale_bias_conv3x3', 'mxnet_tpu_torch/csrc/'
                     'fused_scale_bias_conv3x3.cu',
                     'mxnet_tpu/ops/pallas_conv.py:91', conv_cases,
                     {'train': train_launches['fused_scale_bias_conv3x3']},
                     'F.conv2d on the normalized input'),
        {**gemm_summary('fused_dot_epilogue', 'mxnet_tpu_torch/csrc/'
                        'fused_dot_epilogue.cu',
                        'mxnet_tpu/ops/pallas_fused.py:328', epi_cases,
                        {'lm-train': lm_launches['fused_dot_epilogue']},
                        'torch.addmm (product and bias, no relu)', lm_per),
         **route_summary(epi_cases, {'lm-train': lm_routes})},
        gemm_summary('flash_attention', 'mxnet_tpu_torch/csrc/'
                     'flash_attention.cu',
                     'mxnet_tpu/ops/pallas_attention.py:197', att_cases,
                     {'lm-train': lm_launches['flash_attention']},
                     'F.scaled_dot_product_attention(is_causal=True)',
                     lm_per),
        rtc_summary(rtc_cases, custom_launches['rtc'])]
    print(smi, flush=True)
    log({'kernels': kernels})
    log({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
