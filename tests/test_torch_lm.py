"""The transformer-LM training slice of the PyTorch port against the JAX
package on the CPU: a narrow decoder-only LM (V=200, E=64, 4 heads, 2
layers, T=32, batch 4) under MXTPU_FUSE=aggressive, the JAX side with its
Pallas kernels interpreted (MXTPU_FORCE_PALLAS_INTERPRET), as they run on
a TPU.  The port's graph takes flash_attention and fused_dot_epilogue (their
plain versions on the CPU).

Both packages get the same numpy parameters (``convert.random_params(...,
init='normal')``, the bench leg's N(0, 0.02²) draws) and tokens.
Tolerances: forward outputs rtol 1e-4, atol 1e-6 (f32; summation order
differs, the interpreter emulates the TPU's matmul input precision);
updated parameters rtol 1e-5, atol 1e-6 and their updates within 1e-3 of
the largest update (f32, one step; the update is small against the
weights, so it is compared on its own); bf16 updates by direction (cosine
> 0.97 against the JAX bf16 step: both round every activation to bf16);
3 Module.fit steps rtol 1e-4, atol 1e-5 (tests/test_torch_train.py)."""
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fuse as jfuse
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import train_step as jts
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import fuse as tfuse
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.ops import attention, fused
from mxnet_tpu_torch.parallel import train_step as tts

V, E, HEADS, LAYERS, T, N = 200, 64, 4, 2, 32, 4
CFG = dict(vocab_size=V, num_embed=E, num_heads=HEADS, num_layers=LAYERS,
           seq_len=T)
SHAPES = {'data': (N, T), 'softmax_label': (N, T)}
OPT = dict(lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1.0 / (N * T))


@pytest.fixture(autouse=True)
def _aggressive_interpreted(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')


@pytest.fixture(scope='module')
def case():
    tsym = tmodels.get_symbol('transformer_lm', **CFG)
    arg, _ = convert.random_params(tsym, SHAPES, 0, init='normal')
    toks = np.random.RandomState(1).randint(0, V, (N, T)).astype(np.float32)
    return tsym, arg, {'data': toks, 'softmax_label': (toks + 1) % V}


def _names(sym):
    return [(n.op, n.name) for n in sym.topo_nodes()]


def test_params_are_the_bench_draws(case):
    tsym, arg, _ = case
    rs = np.random.RandomState(0)
    arg_shapes, _, _ = tsym.infer_shape(**SHAPES)
    for name, shp in zip(tsym.list_arguments(), arg_shapes):
        if name not in SHAPES:
            np.testing.assert_array_equal(
                arg[name], rs.normal(0, 0.02, shp).astype(np.float32))
    assert arg['pos_embed_weight'].shape == (T, E)


def test_fused_graph_matches_jax():
    jsym = jmodels.get_symbol('transformer_lm', **CFG)
    tsym = tmodels.get_symbol('transformer_lm', **CFG)
    assert _names(tsym) == _names(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.infer_shape(**SHAPES) == jsym.infer_shape(**SHAPES)
    jout = jfuse.apply_fuse_passes(jsym, True, 'aggressive')
    jstats = jfuse.last_run_stats()
    tout = tfuse.apply_fuse_passes(tsym, True, 'aggressive')
    assert _names(tout) == _names(jout)
    assert tfuse.last_run_stats() == jstats
    ops = Counter(n.op for n in tout.topo_nodes() if not n.is_variable)
    assert ops['_fused_epilogue'] == LAYERS and ops['FlashAttention'] == LAYERS
    lowered = [n.attrs['lower_kernel'] for n in tout.topo_nodes()
               if n.op == '_fused_epilogue']
    assert lowered == [True] * LAYERS


def test_forward_matches_jax(case):
    tsym, arg, batch = case
    jsym = mx.sym.load_json(tsym.tojson())
    tout = tts.make_eval_step(tsym)(
        {k: torch.from_numpy(v) for k, v in arg.items()}, {},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    jout = jts.make_eval_step(jsym)(
        {k: jnp.asarray(v) for k, v in arg.items()}, {},
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    assert tout[0].shape == (N * T, V)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-4, atol=1e-6)


def _step(pkg, tsym, arg, batch, compute_dtype):
    """One make_train_step step; returns (probabilities, new params)."""
    if pkg is tmx:
        params = {k: torch.from_numpy(v.copy()) for k, v in arg.items()}
        step = tts.make_train_step(tsym, tts.make_sgd_momentum(**OPT),
                                   tuple(SHAPES), compute_dtype=compute_dtype)
        outs, params, _, _ = step(
            params, {}, tts.sgd_momentum_init(params),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        return outs[0].float().numpy(), {k: v.numpy()
                                         for k, v in params.items()}
    jsym = mx.sym.load_json(tsym.tojson())
    params = {k: jnp.asarray(v) for k, v in arg.items()}
    step = jts.make_train_step(jsym, jts.make_sgd_momentum(**OPT),
                               tuple(SHAPES), compute_dtype=compute_dtype)
    outs, params, _, _ = step(params, {}, jts.sgd_momentum_init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(0))
    return (np.asarray(outs[0].astype(jnp.float32)),
            {k: np.asarray(v) for k, v in params.items()})


def test_f32_train_step_matches_jax(case):
    tsym, arg, batch = case
    fa0, fe0 = attention.flash_attention.launches, \
        fused.fused_dot_epilogue.launches
    tprob, tparams = _step(tmx, tsym, arg, batch, None)
    jprob, jparams = _step(mx, tsym, arg, batch, None)
    # the CPU path never launches a kernel
    assert (attention.flash_attention.launches,
            fused.fused_dot_epilogue.launches) == (fa0, fe0)
    np.testing.assert_allclose(tprob, jprob, rtol=1e-4, atol=1e-6)
    assert sorted(tparams) == sorted(jparams)
    for k in jparams:
        np.testing.assert_allclose(tparams[k], jparams[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        td, jd = tparams[k] - arg[k], jparams[k] - arg[k]
        assert np.max(np.abs(jd)) > 0, k
        assert np.max(np.abs(td - jd)) <= 1e-3 * np.max(np.abs(jd)), k


def test_bf16_train_step_matches_jax(case):
    """bf16 compute over f32 masters: the token ids are not cast (so ids
    above 256 stay exact), the masters stay f32, and the update points
    where the JAX bf16 step's does."""
    tsym, arg, batch = case
    tprob, tparams = _step(tmx, tsym, arg, batch, torch.bfloat16)
    jprob, jparams = _step(mx, tsym, arg, batch, jnp.bfloat16)
    assert all(v.dtype == np.float32 for v in tparams.values())
    assert np.max(np.abs(tprob - jprob)) <= 2e-2 * np.max(jprob)
    td = np.concatenate([(tparams[k] - arg[k]).ravel() for k in sorted(arg)])
    jd = np.concatenate([(jparams[k] - arg[k]).ravel() for k in sorted(arg)])
    assert np.all(np.isfinite(td))
    assert td @ jd / (np.linalg.norm(td) * np.linalg.norm(jd)) > 0.97


def test_module_fit_matches_jax(case):
    """The user entry: three SGD-momentum steps of Module.fit over an
    NDArrayIter of tokens, in f32 (where Module's batch cast is
    harmless), in both packages."""
    tsym, arg, _ = case
    toks = np.random.RandomState(2).randint(0, V, (3 * N, T)) \
        .astype(np.float32)
    labels = (toks + 1) % V
    opt = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
    mods = []
    # (the JAX symbol from its own constructor: symbol JSON does not carry
    # a Variable's shape in either package)
    for pkg, sym in ((tmx, tsym), (mx, jmodels.get_symbol('transformer_lm',
                                                          **CFG))):
        m = pkg.mod.Module(sym, context=pkg.cpu())
        m.fit(pkg.io.NDArrayIter(toks, labels, batch_size=N), num_epoch=1,
              eval_metric='ce', optimizer='sgd', optimizer_params=opt,
              arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
        mods.append(m)
    (ta, _), (ja, _) = mods[0].get_params(), mods[1].get_params()
    assert sorted(ta) == sorted(ja)
    moved = 0.0
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        moved = max(moved, float(np.max(np.abs(ta[k].asnumpy() - arg[k]))))
    assert moved > 1e-4
