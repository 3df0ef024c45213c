#!/usr/bin/env python3
"""Tile-width sweep of the sm90 GEMM route (mxnet_tpu_torch/csrc/
hopper_gemm.cuh) on the card: each path shape of fused_scale_bias_dot
(ResNet-50 v2 training, 32 rows) and fused_dot_epilogue (the transformer
LM, 16 x 512 tokens), bfloat16, at every tile width the kernel takes
(BN 64, 128, 256 up to N rounded to 64) with the stages and grid
ops/fused.py would give that width; each line names the plan's choice.
The shapes are read from the fused graphs as chip_smoke.py reads them.
Device times are medians of CUDA events, L2 evicted before each launch
(chip_smoke.cuda_ms_each), the widths of one shape timed in turns.

    python3 tools/torch_gemm_sweep.py [--out chiprun_out/gemm_sweep.json]

Prints one JSON line per shape and, last, the card's nvidia-smi line.
Needs a CUDA device.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers and shape readers)

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', help='also write the lines to this file')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_gemm_sweep: no CUDA device', file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import fused
    resnet_dots, _, _ = chip_smoke.train_kernel_shapes(
        mx, resnet.get_symbol(num_classes=1000, num_layers=50,
                              image_shape=chip_smoke.IMAGE),
        chip_smoke.BATCH)
    lm_dots, _ = chip_smoke.lm_kernel_shapes(
        mx, chip_smoke.lm_symbol(models), chip_smoke.LM_BATCH,
        chip_smoke.LM['seq_len'])
    lm_dots = {key[:3]: n for key, n in lm_dots.items()}
    dev = torch.device('cuda', 0)
    sms = fused._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.ones(32 << 20, device=dev)
    plan = fused._sm90_plan
    lines = []
    for kernel, shapes in (('fused_scale_bias_dot', resnet_dots),
                           ('fused_dot_epilogue', lm_dots)):
        for (m, k, n), per_step in sorted(shapes.items()):
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            w = (torch.randn(n, k, generator=gen, device=dev)
                 / k ** 0.5).bfloat16().t()
            s = torch.rand(k, generator=gen, device=dev) + 0.5
            b = torch.randn(k if kernel == 'fused_scale_bias_dot' else n,
                            generator=gen, device=dev) * 0.5
            if kernel == 'fused_scale_bias_dot':
                def call():
                    return fused._dot_launch(x, w, s, b, True, 'sm90')
            else:
                def call():
                    return fused._epi_launch(x, w, b, True, None, 'sm90')
            widths = [bn for bn in (64, 128, 256)
                      if bn <= -(-n // 64) * 64]
            plans = {bn: (bn, fused._sm90_stages(bn),
                          min(-(-m // 128) * -(-n // bn), sms))
                     for bn in widths}

            def forced(p):
                def run():
                    fused._sm90_plan = lambda *_: p
                    try:
                        return call()
                    finally:
                        fused._sm90_plan = plan
                return run
            ms = chip_smoke.cuda_ms_each(
                torch, [forced(p) for p in plans.values()], flush)
            line = {'kernel': kernel, 'mkn': [m, k, n],
                    'launches_per_step': per_step,
                    'plan': list(plan(m, n, sms)),
                    'ms_by_bn': {str(bn): t for bn, t in zip(plans, ms)},
                    'plans': {str(bn): list(p) for bn, p in plans.items()}}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, 'w') as f:
            for line in lines:
                f.write(json.dumps(line) + '\n')
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
