"""Sequence parallelism of the PyTorch port (``parallel/ring.py``,
``parallel/sp.py`` and the FlashAttention op's sp branch) on
``torch.distributed`` with gloo, against the JAX package's
``make_sp_train_step`` on 4 CPU devices (a replicated positional table,
whose length is the local one, against as many devices as ranks).

Each world size (2 and 4 ranks) is one ``torch.multiprocessing.spawn``
whose workers run every case and save their results under ``tmp_path``;
the tests compare them here.  The model is ``tests/test_sp_symbol.py``'s:
the transformer LM at T=32, V=50, E=32, 4 heads, 2 layers, batch 4, with
N(0, 0.05²) parameters from numpy, SGD lr 0.1 momentum 0.9, one step.
Tolerances: updated parameters and outputs rtol 2e-4, atol 2e-5 (the JAX
sp test's own bound against its single-device step); ring and Ulysses
attention against the plain full attention rtol 1e-5, atol 1e-6
(float32, summation order only)."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
from jax.sharding import Mesh

from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import sp as jsp
from mxnet_tpu.parallel import train_step as jts
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.parallel import ring, sp
from mxnet_tpu_torch.parallel import train_step as tts

T, V, BS, E, H, LAYERS = 32, 50, 4, 32, 4, 2
MODES = ('ring', 'ulysses')
SEQ = ('pos_embed_weight',)
OPT = dict(lr=0.1, momentum=0.9, wd=0.0, rescale_grad=1.0 / (BS * T))
# attention cases: [B, H, T, D] global, sharded on T
ATT = (2, 4, 32, 8)
# the step cases every world size runs: the sequence-sharded positional
# table in both modes, and a replicated one (the symbol's table at the
# local length, its gradient all-reduced)
STEP_CASES = [(m, SEQ) for m in MODES] + [('ring', ())]


def _model(seq_len):
    return dict(vocab_size=V, num_embed=E, num_heads=H, num_layers=LAYERS,
                seq_len=seq_len)


def _setup():
    sym = jmodels.get_symbol('transformer_lm', **_model(T))
    arg_shapes, _, _ = sym.infer_shape(data=(BS, T), softmax_label=(BS, T))
    rng = np.random.RandomState(0)
    params = {n: rng.normal(0, 0.05, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ('data', 'softmax_label')}
    data = rng.randint(0, V, (BS, T)).astype(np.float32)
    return params, {'data': data, 'softmax_label': (data + 1) % V}


def _params_for(params, seq_names, n):
    """The global parameters of a case: with a replicated positional table
    the symbol is built at T/n, so its table is the first T/n rows."""
    if seq_names:
        return params
    out = dict(params)
    out['pos_embed_weight'] = params['pos_embed_weight'][:T // n]
    return out


def _att_inputs():
    rng = np.random.RandomState(3)
    return [rng.standard_normal(ATT).astype(np.float32) for _ in range(4)]


def _key(mode, seq_names):
    return '%s_%s' % (mode, 'seq' if seq_names else 'replicated')


def _worker(rank, n, root):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group('gloo', init_method='file://' + os.path.join(
        root, 'store'), world_size=n, rank=rank)
    try:
        mesh = init_device_mesh('cpu', (n,), mesh_dim_names=('seq',))
        group = mesh.get_group('seq')
        out = {}
        q, k, v, cot = (torch.from_numpy(a).narrow(2, rank * (T // n),
                                                    T // n).contiguous()
                        for a in _att_inputs())
        for name, fn in (('ring', ring.ring_attention),
                         ('ulysses', ring.ulysses_attention)):
            for causal in (False, True):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                o = fn(*leaves, group, causal=causal)
                (o * cot).sum().backward()
                tag = 'att_%s_%d' % (name, causal)
                out[tag] = o.detach().numpy()
                for nm, t in zip('qkv', leaves):
                    out['%s_d%s' % (tag, nm)] = t.grad.numpy()
        params, batch = _setup()
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for mode, seq_names in STEP_CASES:
            sym = tmodels.get_symbol('transformer_lm', **_model(T // n))
            p = {k: torch.from_numpy(v)
                 for k, v in _params_for(params, seq_names, n).items()}
            p = sp.shard_sp_params(p, mesh, 'seq', seq_names)
            state = sp.shard_sp_params(tts.sgd_momentum_init(p), mesh, 'seq')
            step = sp.make_sp_train_step(
                sym, mesh, tts.make_sgd_momentum(**OPT), seq_axis='seq',
                seq_param_names=seq_names, attn_mode=mode)
            outs, p, state = step(p, state, batch)
            tag = _key(mode, seq_names)
            out['%s_out' % tag] = outs[0].numpy()
            for k, v in p.items():
                out['%s_p_%s' % (tag, k)] = v.numpy()
        np.savez(os.path.join(root, 'rank%d.npz' % rank), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module', params=[2, 4], ids=['2ranks', '4ranks'])
def world(request, tmp_path_factory):
    """``(n, [per-rank result dicts])`` of one spawn of n gloo workers."""
    n = request.param
    root = str(tmp_path_factory.mktemp('sp%d' % n))
    mp.spawn(_worker, args=(n, root), nprocs=n, join=True)
    return n, [dict(np.load(os.path.join(root, 'rank%d.npz' % r)))
               for r in range(n)]


_JAX = {}


def _jax_step(mode, seq_names, devices):
    """The JAX sp step of a case on ``devices`` CPU devices: (outputs in
    (batch, position) row order, updated params)."""
    key = (mode, seq_names, devices)
    if key not in _JAX:
        mesh = Mesh(np.array(jax.devices()[:devices]), ('seq',))
        params, batch = _setup()
        sym = jmodels.get_symbol('transformer_lm', **_model(T // devices))
        p = _params_for(params, seq_names, devices)
        step = jax.jit(jsp.make_sp_train_step(
            sym, mesh, jts.make_sgd_momentum(**OPT), seq_axis='seq',
            seq_param_names=seq_names, attn_mode=mode))
        outs, p_new, _ = step(
            jsp.shard_sp_params(p, mesh, 'seq', seq_names),
            jsp.shard_sp_params(jts.sgd_momentum_init(p), mesh, 'seq',
                                seq_names),
            batch, jax.random.PRNGKey(0))
        _JAX[key] = (_by_position(np.asarray(outs[0]), devices),
                     {k: np.asarray(v) for k, v in p_new.items()})
    return _JAX[key]


def _by_position(rows, n):
    """Shard-blocked rows (shard, batch, local position) -> (batch,
    position) order."""
    return rows.reshape(n, BS, T // n, -1).transpose(1, 0, 2, 3) \
        .reshape(BS * T, -1)


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('mode', MODES)
def test_sharded_attention_matches_full_attention(world, mode, causal):
    n, ranks = world
    q, k, v, cot = (torch.from_numpy(a) for a in _att_inputs())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ring.full_attention(*leaves, causal=causal)
    (want * cot).sum().backward()
    tag = 'att_%s_%d' % (mode, causal)
    got = np.concatenate([r[tag] for r in ranks], axis=2)
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for nm, t in zip('qkv', leaves):
        grad = np.concatenate([r['%s_d%s' % (tag, nm)] for r in ranks],
                              axis=2)
        np.testing.assert_allclose(grad, t.grad.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg='d' + nm)


@pytest.mark.parametrize('mode', MODES)
def test_sp_step_matches_jax(world, mode):
    """The sequence-sharded positional table (its gradient stays local,
    the rest are all-reduced): both world sizes against JAX's 4 shards,
    whose model is the same global one."""
    _check_step(world, mode, SEQ, _jax_step(mode, SEQ, 4))


def test_sp_step_with_replicated_table_matches_jax(world):
    """Every parameter replicated (the table at the local length, its
    gradient summed over the ranks) against JAX's step on as many
    devices, the same model."""
    n, _ = world
    _check_step(world, 'ring', (), _jax_step('ring', (), n))


def _check_step(world, mode, seq_names, reference):
    n, ranks = world
    want_out, want = reference
    key = _key(mode, seq_names)
    got_out = _by_position(np.concatenate([r['%s_out' % key]
                                           for r in ranks]), n)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-5)
    for name, w in sorted(want.items()):
        per_rank = [r['%s_p_%s' % (key, name)] for r in ranks]
        if name in seq_names:
            got = np.concatenate(per_rank)
        else:
            for other in per_rank[1:]:
                np.testing.assert_array_equal(other, per_rank[0])
            got = per_rank[0]
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_one_rank_sends_nothing(tmp_path, monkeypatch):
    """With one rank the ring rotates nothing (a rank cannot send to
    itself) and both modes equal full attention."""
    from torch.distributed.device_mesh import init_device_mesh
    monkeypatch.setattr(dist, 'batch_isend_irecv', None)
    dist.init_process_group('gloo', init_method='file://' + str(
        tmp_path / 'store'), world_size=1, rank=0)
    try:
        mesh = init_device_mesh('cpu', (1,), mesh_dim_names=('seq',))
        q, k, v, _ = (torch.from_numpy(a) for a in _att_inputs())
        want = ring.full_attention(q, k, v, causal=True)
        for make in (ring.make_ring_attention, ring.make_ulysses_attention):
            got = make(mesh, causal=True)(q, k, v)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()
