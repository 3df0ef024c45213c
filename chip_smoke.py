#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. device  — the card (torch and nvidia-smi).
2. build   — nvcc builds every kernel of csrc/ for sm_90a, in parallel.
3. kernels — each kernel's wrapper on card tensors at the shapes the
             serving path gives it, held against its plain PyTorch version
             (float32: max abs error <= 1e-6; bfloat16: within one bf16
             ulp), timed on the device with CUDA events (median of 50,
             L2 evicted before each launch) beside its plain version and
             its bound, and its host cost per call.
4. serve   — the main path: ModelServer serves full-width ResNet-50 v2
             (1000 classes, 3x224x224, random weights from a numpy seed,
             MXTPU_FUSE=aggressive, pow2 buckets up to 32 rows): after one
             warm-up request per bucket, 64 requests of 1-8 rows from 4
             client threads.  Launch counts are zeroed just before and
             read just after; every kernel of the path must have launched
             (fused_bn_relu: 17 per forward).
5. parity  — 4 rows through the served model and through a CPU
             Predictor, with TF32 off for this phase (cuDNN convolutions
             run TF32 by default): rtol 1e-3, same top-1.

Then the card's nvidia-smi line, the kernels summary line, and the
result line {"ok": true, "device": {...}}.  Without a CUDA device, or
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
BATCH = 32
IMAGE = (3, 224, 224)
N_REQUESTS = 64
N_CLIENTS = 4
SEED = 0


def log(obj):
    print(json.dumps(obj), flush=True)


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


def cuda_ms(torch, fn, flush, reps=50, warmup=10):
    """Median device time of ``fn`` (ms) from CUDA events.  Before each
    run a read of ``flush`` (larger than the 50 MB L2) evicts ``fn``'s
    inputs; a read leaves no dirty lines whose write-back would land in
    the timed run.  A spin kernel first holds the stream while the host
    enqueues every run, so the events bracket device work only and not
    the host's Python/launch overhead (see :func:`host_us`)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = []
    for _ in range(warmup + reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs[warmup:])


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
        from mxnet_tpu_torch import convert, instrument
        from mxnet_tpu_torch.ops import _kernels, fused
        from mxnet_tpu_torch.models import resnet
    except ImportError as e:
        print('chip_smoke: the mxnet_tpu_torch package is missing (%s); run '
              'from the root of a checkout' % e, file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'

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
    del flush
    log({'phase': 'kernels', 'cases': cases})

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
        fused.fused_bn_relu.launches = 0
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

    # -- summary -------------------------------------------------------------
    on_path = [c for c in cases if c['launches_per_forward']]
    summary = {
        'name': 'fused_bn_relu', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/csrc/fused_bn_relu.cu',
        'replaces': 'mxnet_tpu/ops/pallas_fused.py:196',
        'launches': launches['fused_bn_relu'],
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
        'per_forward_of_rows': BATCH, 'cases': cases}
    print(smi, flush=True)
    log({'kernels': [summary]})
    log({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
