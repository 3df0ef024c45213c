#!/usr/bin/env python3
"""Time the sm90 route of flash_attention at other key-tile widths and
K/V ring depths, to check the constants csrc/flash_attention.cu ships
(kBKV = 128 keys per tile, 4 stages at D = 64 and 2 at D = 128).

    python3 tools/torch_flash_tiles.py [--out flash_tiles.json]

Each variant is the shipped source with kBKV and the D = 64 stage count
rewritten, built by nvcc (the port's flags, ops/_kernels.py) into
build/flash_tiles/<variant>/ and bound with ctypes.  Every variant is
held to chip_smoke.py's attention rule against the plain version (O
within 2e-2 of P.|V|, lse within 1e-4 of 1 + |lse|), then all of them
are timed in turns at each shape (CUDA events, median of 50, L2 evicted
before each launch: chip_smoke.cuda_ms_each).  Prints one JSON line per
shape and the card's nvidia-smi line; needs a CUDA device.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (kBKV, stages at D = 64): the shipped constants first
VARIANTS = ((128, 4), (128, 2), (64, 4))
# (BH, Tq, Tk, D, causal): the LM's path shape, then D = 128 and a
# ragged causal one
SHAPES = ((128, 512, 512, 64, True), (16, 256, 256, 128, True),
          (4, 300, 700, 64, True))
_BKV = 'constexpr int kBKV = 128;'
_STAGES = 'constexpr int kStages = D == 64 ? 4 : 2;'


def build(kernels, bkv, stages):
    """The sm90 entry point of one variant, built and bound."""
    src = (kernels.CSRC / 'flash_attention.cu').read_text()
    if _BKV not in src or _STAGES not in src:
        raise SystemExit('flash_attention.cu no longer holds %r and %r'
                         % (_BKV, _STAGES))
    src = src.replace(_BKV, 'constexpr int kBKV = %d;' % bkv).replace(
        _STAGES, 'constexpr int kStages = D == 64 ? %d : 2;' % stages)
    out = kernels.BUILD_DIR.parent / 'flash_tiles' / ('bkv%d_s%d'
                                                      % (bkv, stages))
    out.mkdir(parents=True, exist_ok=True)
    for header in kernels.CSRC.glob('*.cuh'):
        shutil.copy(header, out / header.name)
    (out / 'flash_attention.cu').write_text(src)
    lib = out / 'libflash.so'
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', str(lib),
                    str(out / 'flash_attention.cu'),
                    *kernels._link_flags('flash_attention')],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).mxtpu_flash_attention_sm90
    fn.argtypes = list(kernels.KERNELS['flash_attention'].entries[
        'mxtpu_flash_attention_sm90'])
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', help='also write the results here as JSON')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_flash_tiles: needs a CUDA device', file=sys.stderr)
        return 1
    import chip_smoke
    from mxnet_tpu_torch.ops import _kernels, attention, fused
    fns = {'bkv%d_s%d' % v: build(_kernels, *v) for v in VARIANTS}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    flush = torch.ones(32 << 20, device='cuda')
    results = []
    for bh, tq, tk, d, causal in SHAPES:
        q, k, v = (torch.randn(bh, t, d, generator=gen,
                               device='cuda').bfloat16()
                   for t in (tq, tk, tk))
        scale = d ** -0.5
        o = torch.empty_like(q)
        lse = torch.empty(bh, tq, device='cuda')
        grid = min(bh * -(-tq // 128), fused._sm_count(q.device))
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), bh, tq, tk, d, scale, int(causal), grid,
                     stream)
            if err:
                raise RuntimeError('launch failed: CUDA error %d' % err)

        want, want_lse = attention.flash_attention_plain(q, k, v, scale,
                                                         causal)
        s = torch.einsum('btd,bsd->bts', q.float(), k.float()) * scale
        if causal:
            keep = attention._causal_keep(tq, tk, q.device)
            s = torch.where(keep, s, torch.full_like(s, attention.NEG_INF))
        magnitude = torch.einsum('bts,bsd->btd', torch.softmax(s, -1),
                                 v.float().abs())
        errs = {}
        for name, fn in fns.items():
            run(fn)
            torch.cuda.synchronize()
            ratio = float(((o.float() - want.float()).abs()
                           / magnitude.clamp_min(1e-30)).max())
            lse_ratio = float(((lse - want_lse).abs()
                               / (1 + want_lse.abs())).max())
            if not ratio <= chip_smoke.ATT_RTOL['bfloat16'] or \
                    not lse_ratio <= chip_smoke.LSE_RTOL:
                raise AssertionError('%s at %s: O %g, lse %g' % (
                    name, (bh, tq, tk, d), ratio, lse_ratio))
            errs[name] = ratio
        times = chip_smoke.cuda_ms_each(
            torch, [lambda fn=fn: run(fn) for fn in fns.values()], flush)
        results.append({'bh_tq_tk_d': [bh, tq, tk, d], 'causal': causal,
                        'ms': dict(zip(fns, times)),
                        'err_over_magnitude': errs})
        print(json.dumps(results[-1]), flush=True)
    smi = chip_smoke.nvidia_smi()
    print(smi)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'card': smi, 'results': results}, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
