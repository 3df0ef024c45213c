#!/usr/bin/env python3
"""Where the time of a training step goes, on the GPU, in the PyTorch
port (mxnet_tpu_torch).

    python3 tools/torch_profile_training.py [--model resnet] [--rows 32]
    python3 tools/torch_profile_training.py --model transformer_lm [--rows 16]
    python3 tools/torch_profile_training.py --model resnet_custom_head
    python3 tools/torch_profile_training.py --model transformer_lm_bucket \
        [--bucket 200]
    python3 tools/torch_profile_training.py --model lstm_lm [--rows 32]
    python3 tools/torch_profile_training.py --model inception_v3 [--rows 32]

``resnet``: full-width ResNet-50 v2 (1000 classes, 3x224x224) trained
with Module.fit (bf16 compute, SGD lr 0.05 momentum 0.9 wd 1e-4).
``resnet_custom_head``: the same in float32 (TF32 off) with chip_smoke.py's
Custom ``softmax_rtc`` loss head, whose operator pushes two Rtc kernels.
``transformer_lm``: the JAX package's transformer-LM bench leg
(bench.py:958-994: V=32000, E=512, 8 heads, 6 layers, T=512) through
parallel.make_train_step (bf16 compute, SGD lr 0.01 momentum 0.9,
N(0, 0.02²) weights).  ``transformer_lm_bucket``: that LM as
chip_smoke.py's bucket-train runs it, mod.BucketingModule over
sym_gen_bucketing (positional table of 512 rows) in float32 with TF32
off, SGD lr 0.01 momentum 0.9, one bucket's fit step (``--bucket``, a
sequence length up to 512; the batch's last position padded with -1).
``lstm_lm``: the JAX package's PTB LSTM bench leg (bench.py:914-955:
V=10000, E=H=200, 2 layers, T=35) through parallel.make_train_step in
float32 (TF32 off), SGD lr 0.1 momentum 0.9, N(0, 0.05²) weights.
``inception_v3``: Inception-v3 (1000 classes, 3x299x299) trained with
Module.fit as ``resnet`` is, at lr 0.01.  Random weights and data from
numpy seeds,
MXTPU_FUSE=aggressive.  For each ``--engine`` (default both, eager
first): the step built under ``NaiveEngine`` (op by op) or captured (one
CUDA graph, replayed), two warm-up steps, then ``--steps`` more fused
train steps under torch.profiler: wall and device-busy time per step,
the device's idle share, kernel time by class and by name, kernels
launched per step, and the port's kernel launches per step from their
counters.  Prints one JSON line per engine; needs a CUDA device.
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

LM = dict(vocab_size=32000, num_embed=512, num_heads=8, num_layers=6,
          seq_len=512)


def resnet_step(mx, torch, rows, seed, custom_head=False):
    """A 32-row ResNet-50 v2 Module (bf16, or float32 with the Custom
    Rtc head), fitted for two warm-up steps; returns the fit step to
    profile."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import resnet
    shape = (rows, 3, 224, 224)
    if custom_head:
        import chip_smoke
        chip_smoke.register_user_ops(mx)
        symbol = chip_smoke.custom_symbol(mx, resnet)
        torch.backends.cudnn.allow_tf32 = False
    else:
        symbol = resnet.get_symbol(num_classes=1000, num_layers=50)
    arg, aux = convert.random_params(symbol, {'data': shape}, seed)
    rng = np.random.default_rng(seed + 1)
    images = rng.standard_normal((2 * rows,) + shape[1:], dtype=np.float32)
    labels = rng.integers(0, 1000, 2 * rows).astype(np.float32)
    it = mx.io.NDArrayIter(images, labels, batch_size=rows)
    mod = mx.mod.Module(symbol, context=mx.gpu(0),
                        compute_dtype=None if custom_head else
                        torch.bfloat16)
    mod.fit(it, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': 0.05, 'momentum': 0.9,
                              'wd': 1e-4},
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    it.reset()
    batch = next(it)
    metric = mx.metric.create('acc')
    mod._fit_step(batch, metric)            # builds the step for the metric
    return lambda: mod._fit_step(batch, metric)


def lm_step(mx, torch, rows, seed):
    """The bench leg's LM train step after two warm-up steps."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import train_step as ts
    seq = LM['seq_len']
    symbol = mx.models.get_symbol('transformer_lm', **LM)
    arg, _ = convert.random_params(
        symbol, {'data': (rows, seq), 'softmax_label': (rows, seq)}, seed,
        init='normal')
    dev = torch.device('cuda', 0)
    params = {k: torch.from_numpy(v).to(dev) for k, v in arg.items()}
    state = ts.sgd_momentum_init(params)
    toks = np.random.RandomState(seed + 1).randint(
        0, LM['vocab_size'], (rows, seq)).astype(np.float32)
    batch = {'data': torch.from_numpy(toks).to(dev),
             'softmax_label': torch.from_numpy(
                 (toks + 1) % LM['vocab_size']).to(dev)}
    step = ts.make_train_step(
        symbol, ts.make_sgd_momentum(lr=0.01, momentum=0.9, wd=0.0,
                                     rescale_grad=1.0 / (rows * seq)),
        ('data', 'softmax_label'), compute_dtype=torch.bfloat16)

    def run():
        step(params, {}, state, batch)
    for _ in range(2):
        run()
    return run


def lstm_step(mx, torch, rows, seed):
    """The PTB LSTM bench leg's train step after two warm-up steps."""
    import chip_smoke
    from mxnet_tpu_torch.parallel import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    symbol = mx.models.get_symbol('lstm_lm', seq_len=chip_smoke.LSTM_T,
                                  **chip_smoke.LSTM_PTB)
    arg, batch = chip_smoke.lstm_bench_draws(symbol)
    dev = torch.device('cuda', 0)
    params = {k: torch.from_numpy(v).to(dev) for k, v in arg.items()}
    state = ts.sgd_momentum_init(params)
    batch = {k: torch.from_numpy(v[:rows]).to(dev) for k, v in batch.items()}
    step = ts.make_train_step(
        symbol, ts.make_sgd_momentum(lr=0.1, momentum=0.9, wd=0.0,
                                     rescale_grad=1.0 / rows),
        ('data', 'softmax_label'))

    def run():
        step(params, {}, state, batch)
    for _ in range(2):
        run()
    return run


def inception_step(mx, torch, rows, seed):
    """Inception-v3's Module.fit step (bf16) after two warm-up steps."""
    from mxnet_tpu_torch import convert
    shape = (rows, 3, 299, 299)
    symbol = mx.models.get_symbol('inception-v3', num_classes=1000)
    arg, aux = convert.random_params(symbol, {'data': shape}, seed)
    rng = np.random.default_rng(seed + 1)
    images = rng.standard_normal((2 * rows,) + shape[1:], dtype=np.float32)
    labels = rng.integers(0, 1000, 2 * rows).astype(np.float32)
    it = mx.io.NDArrayIter(images, labels, batch_size=rows)
    mod = mx.mod.Module(symbol, context=mx.gpu(0),
                        compute_dtype=torch.bfloat16)
    mod.fit(it, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': 0.01, 'momentum': 0.9,
                              'wd': 1e-4},
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    it.reset()
    batch = next(it)
    metric = mx.metric.create('acc')
    mod._fit_step(batch, metric)
    return lambda: mod._fit_step(batch, metric)


def bucket_step(mx, torch, rows, seed, bucket):
    """The bucketed LM's fit step at ``bucket`` after two warm-up steps."""
    import chip_smoke
    from mxnet_tpu_torch import convert
    torch.backends.cuda.matmul.allow_tf32 = False
    default = max(chip_smoke.BUCKETS)
    gen = chip_smoke.bucket_gen(mx.models)
    shapes = [('data', (rows, default))], [('softmax_label', (rows, default))]
    arg, _ = convert.random_params(gen(default)[0],
                                   dict(shapes[0] + shapes[1]), seed,
                                   init='normal')
    toks = np.random.RandomState(seed + 1).randint(
        0, LM['vocab_size'], (rows, bucket)).astype(np.float32)
    labels = np.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    batch = mx.io.DataBatch([mx.nd.array(toks)], [mx.nd.array(labels)],
                            bucket_key=bucket,
                            provide_data=[('data', (rows, bucket))],
                            provide_label=[('softmax_label', (rows, bucket))])
    mod = mx.mod.BucketingModule(gen, default_bucket_key=default,
                                 context=mx.gpu(0))
    mod.bind(*shapes)
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in arg.items()})
    mod.init_optimizer(optimizer='sgd', optimizer_params={
        'learning_rate': 0.01, 'momentum': 0.9})
    metric = mx.metric.create('acc')
    for _ in range(2):
        mod._fit_step(batch, metric)
    return lambda: mod._fit_step(batch, metric)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=('resnet', 'transformer_lm',
                                        'resnet_custom_head',
                                        'transformer_lm_bucket', 'lstm_lm',
                                        'inception_v3'),
                    default='resnet')
    ap.add_argument('--bucket', type=int, default=200,
                    help='transformer_lm_bucket: the bucket (sequence '
                         'length) whose step is profiled')
    ap.add_argument('--rows', type=int, default=None,
                    help='rows per step (default 32 resnet, 16 LM)')
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--engine', choices=('both', 'eager', 'captured'),
                    default='both')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import attention, fused, fused_conv
    from torch_profile_serving import profile_window
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lm = args.model.startswith('transformer_lm')
    custom = args.model == 'resnet_custom_head'
    rows = args.rows or (16 if lm else 32)
    bucketed = args.model == 'transformer_lm_bucket'
    f32 = custom or bucketed or args.model == 'lstm_lm'
    counters = (fused.fused_bn_relu, fused.fused_scale_bias_dot,
                fused_conv.fused_scale_bias_conv3x3,
                fused.fused_dot_epilogue, attention.flash_attention,
                mx.rtc.Rtc)
    engines = ('eager', 'captured') if args.engine == 'both' else \
        (args.engine,)
    for engine in engines:
        mx.engine.set_engine_type('NaiveEngine' if engine == 'eager' else
                                  'ThreadedEnginePerDevice')
        if args.model == 'lstm_lm':
            run = lstm_step(mx, torch, rows, args.seed)
        elif args.model == 'inception_v3':
            run = inception_step(mx, torch, rows, args.seed)
        elif bucketed:
            run = bucket_step(mx, torch, rows, args.seed, args.bucket)
        elif lm:
            run = lm_step(mx, torch, rows, args.seed)
        else:
            run = resnet_step(mx, torch, rows, args.seed, custom)
        torch.cuda.synchronize()
        before = [k.launches for k in counters]
        out = profile_window(torch, run, args.steps, unit='step')
        out.update(card=smi, model=args.model, rows=rows, engine=engine,
                   bucket=args.bucket if bucketed else None,
                   compute_dtype='float32' if f32 else 'bfloat16',
                   fuse='aggressive',
                   port_kernel_launches_per_step={
                       k.__name__: (k.launches - b) / args.steps
                       for k, b in zip(counters, before) if k.launches > b})
        print(json.dumps(out), flush=True)
        del run
    return 0


if __name__ == '__main__':
    sys.exit(main())
