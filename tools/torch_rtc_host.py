#!/usr/bin/env python3
"""Host time of one ``mx.rtc.Rtc.push`` (kernel #6, the NVRTC bridge),
stage by stage, beside ``torch.softmax``'s on the same input.

    python3 tools/torch_rtc_host.py [--root DIR] [--reps 500] [--out FILE]

Imports ``mxnet_tpu_torch`` and ``chip_smoke.py`` from DIR (default: the
checkout holding this script), so the same script times a ``git archive``
of another commit: run it on both trees, in turns, in one call to the card
(host times move by 10-30 us between calls).  At the Custom head's shape
(32, 1000) and the LM head's (8192, 32000) it pushes the softmax forward
of DIR's ``chip_smoke.softmax_kernels`` and reports, in us, the median
over ``--reps`` calls on the host clock (a device synchronise every 50
rounds; every function below is called once per round, in turns):

- ``push_us``: one whole push (``bwd_push_us``: the backward's, two
  inputs);
- ``stages_us``: each step of the push alone, written out below as DIR's
  ``rtc.py`` takes it (the design is read from the bridge's entry points:
  ``ctx_push`` for per-argument ctypes objects and a context push and pop
  around every launch, ``plan`` for one cached launch plan), and their sum;
- ``probes_us``: the alternatives for the costly steps (three ways to
  allocate the output, two to read the stream, a ctypes call that does no
  work), torch's own launch of a small kernel, and ``torch.softmax``.

Prints one JSON object per shape and, with ``--out``, writes them all.
Exits nonzero without a CUDA device.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = ((32, 1000), (8192, 32000))


def host_us_each(torch, fns, reps):
    """Median host time (us) of one call of each of ``fns`` (a dict), the
    functions called in turns, round after round, so that all see the
    same state of a host whose speed drifts; a device synchronise every
    50 rounds."""
    times = {k: [] for k in fns}
    for i in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return {k: statistics.median(v) * 1e6 for k, v in times.items()}


def ctx_push_stages(torch, rtc, kernel, ins, outs, grid, block):
    """The steps of the push that launches through ``mxtpu_rtc_launch``."""
    NDArray = rtc.NDArray
    shim = rtc._get_shim()
    xs = [x.handle for x in ins]
    dev = xs[0].device
    ys = [torch.empty(o.shape, dtype=o.dtype, device=dev) for o in outs]
    in_dt, out_dt = tuple(t.dtype for t in xs), tuple(t.dtype for t in ys)
    ctx, _, function = kernel._function(shim, dev, in_dt, out_dt)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in xs + ys]
    params = (ctypes.c_void_p * len(ptrs))(
        *[ctypes.addressof(p) for p in ptrs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    g, b = rtc._dims(grid, 'grid_dims'), rtc._dims(block, 'block_dims')

    def arguments():
        p = [ctypes.c_void_p(t.data_ptr()) for t in xs + ys]
        return (ctypes.c_void_p * len(p))(*[ctypes.addressof(q) for q in p])

    return {
        'checks': lambda: (len(ins) != len(kernel.input_names),
                           [rtc._tensor(x) for x in ins],
                           [isinstance(o, NDArray) for o in outs]),
        'dims': lambda: (rtc._dims(grid, 'grid_dims'),
                         rtc._dims(block, 'block_dims')),
        'devices': lambda: next(iter({t.device for t in xs}
                                     | {o.handle.device for o in outs})),
        'contiguous': lambda: [t.contiguous() for t in xs],
        'outputs': lambda: [torch.empty(o.shape, dtype=o.dtype, device=dev)
                            for o in outs],
        'module_cache': lambda: kernel._function(
            shim, dev, tuple(t.dtype for t in xs),
            tuple(t.dtype for t in ys)),
        'arguments': arguments,
        'stream': lambda: torch.cuda.current_stream(dev).cuda_stream,
        # params holds the addresses of ptrs' objects: keep them alive
        'launch': lambda keep=ptrs: shim.launch(ctx, function, *g, *b,
                                                params, stream),
        'count': _counter(rtc),
        'swap': lambda: [o._set_data(y) for o, y in zip(outs, ys)],
    }


def _counter(rtc):
    """The push's launch count: through ``instrument.count_launch``, or
    under the module's own lock in a tree from before it."""
    if hasattr(rtc.instrument, 'count_launch'):
        return lambda: rtc.instrument.count_launch(rtc.Rtc)

    def count():
        with rtc._count_lock:
            rtc.Rtc.launches += 1
    return count


def plan_stages(torch, rtc, kernel, ins, outs, grid, block):
    """The steps of the push that launches one cached plan through
    ``mxtpu_rtc_launch_record``."""
    NDArray = rtc.NDArray
    xs = [x.handle for x in ins]
    olds = [o.handle for o in outs]
    kernel.push(ins, outs, grid, block)        # the plan exists
    ctx, function, launch, index, _ = kernel._cache[rtc._key(xs + olds)]
    ys = [torch.empty_like(t, memory_format=torch.contiguous_format)
          for t in olds]
    stream = rtc._raw_stream(index)
    g, b = rtc._dims(grid, 'grid_dims'), rtc._dims(block, 'block_dims')
    record = rtc._pack(kernel._record, ctx, function, stream, g, b, xs + ys)

    return {
        'checks': lambda: (len(ins) != len(kernel.input_names),
                           [rtc._tensor(x) for x in ins],
                           [isinstance(o, NDArray) for o in outs]),
        'dims': lambda: (rtc._dims(grid, 'grid_dims'),
                         rtc._dims(block, 'block_dims')),
        # the key holds each argument's device: a hit is the device check
        'plan_cache': lambda: kernel._cache.get(rtc._key(
            xs + [o.handle for o in outs])),
        'contiguous': lambda: [t.contiguous() for t in xs],
        'outputs': lambda: [torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in olds],
        'stream': lambda: rtc._raw_stream(index),
        'launch_record': lambda: rtc._pack(kernel._record, ctx, function,
                                           stream, g, b, xs + ys),
        'launch': lambda: launch(record),
        'count': _counter(rtc),
        'swap': lambda: [o._set_data(y) for o, y in zip(outs, ys)],
    }


def measure(torch, mx, smoke, rows, n, reps):
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, n, generator=gen, device=dev)
    xa = mx.nd.NDArray(x)
    y = mx.nd.NDArray(torch.empty_like(x))
    label = mx.nd.NDArray(torch.randint(0, n, (rows,), generator=gen,
                                        device=dev).float())
    dx = mx.nd.NDArray(torch.empty_like(x))
    fwd, bwd = smoke.softmax_kernels(mx, n)
    grid, block = (rows, 1, 1), (smoke.rtc_block(n), 1, 1)
    fwd.push([xa], [y], grid, block)
    bwd.push([y, label], [dx], grid, block)
    torch.cuda.synchronize()
    shim = mx.rtc._get_shim()
    design = 'plan' if hasattr(shim, 'launch_record') else 'ctx_push'
    make = plan_stages if design == 'plan' else ctx_push_stages
    stages = make(torch, mx.rtc, fwd, [xa], [y], grid, block)
    pushes = {'push': lambda: fwd.push([xa], [y], grid, block),
              'bwd_push': lambda: bwd.push([y, label], [dx], grid, block)}
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    probes = {
        'torch.empty(shape, dtype, device)':
            lambda: torch.empty(x.shape, dtype=x.dtype, device=dev),
        'torch.empty_like(contiguous_format)':
            lambda: torch.empty_like(
                x, memory_format=torch.contiguous_format),
        'Tensor.new_empty(shape)': lambda: x.new_empty(x.shape),
        'torch.cuda.current_stream(dev).cuda_stream':
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        'ctypes call, no work (mxtpu_cuda_error_string)':
            lambda: shim.cuda_error(0),
        'torch.neg_ of a (32,) tensor (torch launch)':
            lambda s=torch.zeros(32, device=dev): s.neg_(),
        'torch.softmax(x, 1)': lambda: torch.softmax(x, 1),
    }
    if raw is not None:
        probes['torch._C._cuda_getCurrentRawStream(0)'] = lambda: raw(0)
    us = host_us_each(torch, {**pushes, **stages, **probes}, reps)
    out = {'shape': [rows, n], 'design': design, 'block': list(block),
           'push_us': us['push'], 'bwd_push_us': us['bwd_push'],
           'stages_us': {k: us[k] for k in stages},
           'probes_us': {k: us[k] for k in probes}}
    out['stage_sum_us'] = sum(out['stages_us'].values())
    out['softmax_host_us'] = out['probes_us']['torch.softmax(x, 1)']
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument('--reps', type=int, default=500)
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_rtc_host: no CUDA device; this script times the card',
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import mxnet_tpu_torch as mx
    if os.path.dirname(os.path.dirname(os.path.abspath(mx.__file__))) \
            != root:
        print('torch_rtc_host: mxnet_tpu_torch imported from %s, not %s'
              % (mx.__file__, root), file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', os.path.join(root, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    results = []
    for rows, n in SHAPES:
        r = measure(torch, mx, smoke, rows, n, args.reps)
        r.update(root=root, card=smi, torch=torch.__version__,
                 reps=args.reps)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
