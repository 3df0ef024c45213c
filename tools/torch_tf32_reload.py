#!/usr/bin/env python3
"""Why a reloaded FeedForward predicts otherwise than the trained one under
TF32, on the GPU, in the PyTorch port (mxnet_tpu_torch).

    python3 tools/torch_tf32_reload.py [--out chiprun_out/tf32_reload.json]

chip_smoke.py's feedforward case: full-width ResNet-50 v2 (1000 classes,
3x224x224, random weights from a numpy seed, MXTPU_FUSE=aggressive),
FeedForward.create over 128 images (float32, TF32 off, SGD with momentum,
batch 32), saved and loaded back; then both models predict the same 64
images with TF32 on.  The script reports:

- the predictions of the trained model twice, of the loaded model, and of
  the loaded model held at the trained model's predict batch (32 rows;
  a loaded FeedForward's default ``numpy_batch_size`` is 128, so it
  predicts the 64 images as one 64-row batch): max abs difference, the
  rows that differ in each 32-row block;
- the same with TF32 on only for cuDNN and only for cuBLAS, and with
  ``torch.backends.cudnn.benchmark``;
- with TF32 on, predictions in turns (trained, loaded, loaded, trained),
  each against the first; with cuDNN deterministic; and after the
  caching allocator's free blocks were filled with NaN (a kernel that
  reads memory it did not write would then show it);
- per node of the inference program (the aggressive pass pipeline's, the
  program predict runs), the first node whose output differs between the
  two models' inference modules on each batch, with each input's
  shape, strides, dtype and data_ptr modulo 1024 in both modules; and
  that node run again on copies of its inputs at fresh addresses.

Prints one JSON line; needs a CUDA device.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS, BATCH, EVAL_ROWS, SEED = 128, 32, 64, 0
IMAGE = (3, 224, 224)
SGD = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


def set_tf32(torch, cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def diff_rows(a, b):
    """Rows that differ, by batch: {batch: [row in batch]}."""
    rows = np.nonzero(np.any(a != b, axis=1))[0].tolist()
    out = {}
    for r in rows:
        out.setdefault(r // BATCH, []).append(r % BATCH)
    return out


def compare(a, b):
    return {'max_abs_diff': float(np.max(np.abs(a - b))),
            'rows_differing_by_batch': diff_rows(a, b)}


def tapped(torch, module, batch):
    """Every node output of the module's inference program on ``batch``,
    in graph order, with the tensors each node read."""
    from mxnet_tpu_torch.executor import _build_graph_fn
    exe = module._exec_group.execs[0]
    module._exec_group.load_batch(batch)
    program = exe._program_symbol(False)
    fn = _build_graph_fn(program, False, monitor_re=re.compile('.*'))
    args = {k: v.handle for k, v in exe.arg_dict.items()}
    aux = {k: v.handle for k, v in exe.aux_dict.items()}
    with torch.no_grad():
        _, _, taps = fn(args, aux)
    return program, taps, args, aux


def input_report(t):
    return {'shape': list(t.shape), 'stride': list(t.stride()),
            'dtype': str(t.dtype), 'ptr_mod_1024': t.data_ptr() % 1024,
            'contiguous': t.is_contiguous()}


def in_turns(torch, model, back, data):
    """TF32 on: predictions of the trained and the loaded model in turns,
    each against the first."""
    outs = [(name, ff.predict(data)) for name, ff in (
        ('trained', model), ('loaded', back), ('loaded', back),
        ('trained', model))]
    return [{'run': name, **compare(outs[0][1], out)} for name, out in outs]


def poison_free_memory(torch):
    """Fill the caching allocator's free blocks with NaN: allocate what
    is free in them, fill it, free it again."""
    stats = torch.cuda.memory_stats()
    free = stats['reserved_bytes.all.current'] - \
        stats['allocated_bytes.all.current']
    if free >= 4:
        junk = torch.full((free // 4,), float('nan'), device='cuda')
        del junk


def locate(torch, mx, model, back, data, index=0):
    """The first node of the inference program whose output differs
    between the two models' modules, on batch ``index``."""
    it = mx.io.NDArrayIter(data[index * BATCH:(index + 1) * BATCH],
                           batch_size=BATCH)
    batch = next(iter(it))
    runs = []
    for ff in (model, back):
        it.reset()
        mod = ff._inference_module(it, None)
        runs.append((mod,) + tapped(torch, mod, batch))
    (_, program, taps_a, args_a, aux_a), (_, _, taps_b, args_b, aux_b) = \
        runs
    entries_a, entries_b = dict(args_a, **aux_a), dict(args_b, **aux_b)
    entries_a.update(taps_a)
    entries_b.update(taps_b)
    differing = 0
    first = None
    for node in program.topo_nodes():
        if node.is_variable:
            continue
        for name in node.output_names():
            if not torch.equal(taps_a[name], taps_b[name]):
                differing += 1
                if first is None:
                    first = node
    if first is None:
        return {'differing_outputs': 0}
    ins = []
    for src, idx in first.inputs:
        key = src.output_names()[idx] if not src.is_variable else src.name
        a, b = entries_a[key], entries_b[key]
        ins.append({'name': key, 'equal_values': bool(torch.equal(a, b)),
                    'trained': input_report(a), 'loaded': input_report(b)})
    # the node again on fresh copies of its inputs (new addresses, the
    # same values and strides)
    from mxnet_tpu_torch.ops import get_op
    op = get_op(first.op)
    reruns = []
    for entries in (entries_a, entries_b):
        xs = [entries[i['name']].clone() for i in ins]
        with torch.no_grad():
            reruns.append(op.apply(first.attrs, xs, False, None)[0][0])
    out = first.output_names()[0]
    return {'differing_outputs': differing, 'first_node': first.name,
            'op': first.op, 'attrs': {k: str(v) for k, v in
                                      first.attrs.items()},
            'inputs': ins,
            'output_max_abs_diff': float(
                (taps_a[out] - taps_b[out]).abs().max()),
            'rerun_on_fresh_copies_equal': bool(torch.equal(*reruns)),
            'rerun_trained_vs_trained_module': bool(
                torch.equal(reruns[0], taps_a[out]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_tf32_reload: needs a CUDA device', file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import resnet
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                     SEED)
    rng = np.random.default_rng(SEED + 2)
    images = rng.standard_normal((ROWS,) + IMAGE, dtype=np.float32)
    labels = rng.integers(0, 1000, ROWS).astype(np.float32)
    set_tf32(torch, False, False)
    np.random.seed(SEED)
    model = mx.FeedForward.create(
        symbol, images, labels, ctx=mx.gpu(0), num_epoch=1,
        numpy_batch_size=BATCH,
        arg_params={k: mx.nd.array(v) for k, v in arg.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()}, **SGD)
    data = images[:EVAL_ROWS]
    report = {'device': torch.cuda.get_device_name(0),
              'nvidia_smi': subprocess.run(
                  ['nvidia-smi', '--query-gpu=name,power.limit',
                   '--format=csv,noheader'], capture_output=True,
                  text=True).stdout.strip(),
              'torch': torch.__version__, 'cudnn': torch.backends.cudnn
              .version()}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, 'ff')
        model.save(prefix)
        back = mx.FeedForward.load(prefix, 1, ctx=mx.gpu(0))
        report['params_bit_identical'] = all(
            np.array_equal(model.arg_params[k].asnumpy(),
                           back.arg_params[k].asnumpy())
            for k in model.arg_params)
        # predict batches min(rows, numpy_batch_size): the trained model
        # was made with numpy_batch_size 32, a loaded one defaults to 128
        same = mx.FeedForward.load(prefix, 1, ctx=mx.gpu(0),
                                   numpy_batch_size=BATCH)
        report['predict_batch'] = {
            'trained': min(EVAL_ROWS, model.numpy_batch_size),
            'loaded': min(EVAL_ROWS, back.numpy_batch_size),
            'loaded_at_trained_batch': min(EVAL_ROWS,
                                           same.numpy_batch_size)}
        for name, cudnn, matmul, bench in (
                ('tf32_off', False, False, False),
                ('tf32_on', True, True, False),
                ('tf32_cudnn_only', True, False, False),
                ('tf32_cublas_only', False, True, False),
                ('tf32_on_cudnn_benchmark', True, True, True)):
            set_tf32(torch, cudnn, matmul)
            torch.backends.cudnn.benchmark = bench
            a = model.predict(data)
            a2 = model.predict(data)
            b = back.predict(data)
            report[name] = {'trained_twice': compare(a, a2),
                            'trained_vs_loaded': compare(a, b),
                            'trained_vs_loaded_at_trained_batch':
                                compare(a, same.predict(data))}
        torch.backends.cudnn.benchmark = False
        set_tf32(torch, True, True)
        report['tf32_on_in_turns'] = in_turns(torch, model, back, data)
        torch.backends.cudnn.deterministic = True
        report['tf32_on_cudnn_deterministic_in_turns'] = in_turns(
            torch, model, back, data)
        torch.backends.cudnn.deterministic = False
        poison_free_memory(torch)
        a = model.predict(data)
        poison_free_memory(torch)
        b = back.predict(data)
        report['tf32_on_after_nan_fill'] = {
            'finite': bool(np.all(np.isfinite(a)) and
                           np.all(np.isfinite(b))),
            'trained_vs_loaded': compare(a, b)}
        for index in range(EVAL_ROWS // BATCH):
            report['first_differing_node_tf32_on_batch%d' % index] = \
                locate(torch, mx, model, back, data, index)
        set_tf32(torch, False, False)
        report['first_differing_node_tf32_off'] = locate(torch, mx, model,
                                                         back, data)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
