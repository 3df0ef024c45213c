"""flash_attention in the PyTorch port (mxnet_tpu_torch/ops/attention.py)
against the JAX package's (mxnet_tpu/ops/pallas_attention.py): its plain
version against ``_ref_attention``, and the autograd Function (plain
forward, blockwise ``_flash_bwd`` backward) against the Pallas kernel run
through the interpreter, outputs and ``jax.grad`` through the reference's
``_flash_bwd``.

Inputs come from numpy seeds.  Tolerances: float32 rtol 1e-5, atol 1e-6
against ``_ref_attention`` (the same dense f32 arithmetic; only summation
order differs); 2e-3 against the interpreted kernel and its gradients
(tests/test_pallas_attention.py's bound: the interpreter emulates the
TPU's matmul input precision); bfloat16 within 2e-2 of the output's
scale (one bf16 rounding of O on each side and the inputs' rounding)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as ta

# (q shape, k/v shape, causal): 4-D and 3-D, tq == tk, tq < tk (bottom-
# right aligned), tq > tk causal (leading rows fully masked: the dense
# form's uniform weights), a ragged T no block divides
CASES = [
    ((2, 2, 64, 16), (2, 2, 64, 16), True),
    ((2, 2, 64, 16), (2, 2, 64, 16), False),
    ((3, 32, 8), (3, 64, 8), True),
    ((3, 40, 8), (3, 24, 8), True),
    ((2, 37, 16), (2, 53, 16), False),
]
IDS = ['bhtd-causal', 'bhtd', 'tq<tk-causal', 'masked-rows', 'ragged']


def _inputs(qs, ks, seed):
    r = np.random.RandomState(seed)
    return (r.randn(*qs).astype(np.float32), r.randn(*ks).astype(np.float32),
            r.randn(*ks).astype(np.float32), r.randn(*qs).astype(np.float32))


def _as3(a):
    return a.reshape(-1, a.shape[-2], a.shape[-1])


@pytest.mark.parametrize('qs,ks,causal', CASES, ids=IDS)
def test_plain_matches_ref_attention(qs, ks, causal):
    q, k, v, _ = _inputs(qs, ks, 0)
    scale = 1.0 / np.sqrt(qs[-1])
    o, lse = ta.flash_attention_plain(*[torch.from_numpy(_as3(a))
                                        for a in (q, k, v)], scale, causal)
    jo, jlse = pa._ref_attention(*[jnp.asarray(_as3(a)) for a in (q, k, v)],
                                 scale, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-6)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize('qs,ks,causal', CASES, ids=IDS)
def test_forward_and_grads_match_jax_kernel(qs, ks, causal, monkeypatch):
    """Output and d(sum(o * w))/d(q, k, v) of the port's flash_attention
    against the JAX one with the Pallas interpreter forced (its custom_vjp
    backward is ``_flash_bwd``; the dense cases take the reference's jnp
    form there)."""
    q, k, v, w = _inputs(qs, ks, 1)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = ta.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad(o, ts, torch.from_numpy(w))
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')

    def loss(q, k, v):
        return jnp.sum(pa.flash_attention(q, k, v, causal=causal)
                       * jnp.asarray(w))
    jo = pa.flash_attention(*[jnp.asarray(a) for a in (q, k, v)],
                            causal=causal)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in (q, k, v)])
    assert o.shape == qs and o.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=2e-3, atol=2e-3)
    for name, a, b in zip('qkv', got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3, err_msg='d' + name)


def test_blockwise_backward_matches_dense_autograd():
    """Tq = 768 runs the backward in three 256-row query blocks; its
    gradients equal autograd through the dense plain form."""
    q, k, v, w = _inputs((2, 768, 8), (2, 768, 8), 2)
    grads = []
    for fn in (lambda *a: ta.flash_attention(*a, causal=True),
               lambda *a: ta.flash_attention_plain(*a, 1 / np.sqrt(8),
                                                   True)[0]):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ts), ts, torch.from_numpy(w)))
    assert ta._pick_block(768, ta.DEFAULT_BLOCK_Q) == 256
    for name, a, b in zip('qkv', *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg='d' + name)


def test_bf16_matches_jax():
    q, k, v, _ = _inputs((2, 2, 64, 16), (2, 2, 64, 16), 3)
    got = ta.flash_attention(*[torch.from_numpy(a).to(torch.bfloat16)
                               for a in (q, k, v)], causal=True)
    assert got.dtype == torch.bfloat16
    want = pa.flash_attention(*[jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)], causal=True)
    want = np.asarray(want.astype(jnp.float32))
    err = np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want))
    assert err <= 2e-2


def test_cpu_path_never_touches_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('the CPU path reached the CUDA kernel loader')
    monkeypatch.setattr(ta._kernels, 'load', boom)
    before = ta.flash_attention.launches
    q, k, v, _ = _inputs((2, 16, 8), (2, 16, 8), 4)
    ta.flash_attention(*[torch.from_numpy(a) for a in (q, k, v)],
                       causal=True)
    assert ta.flash_attention.launches == before


def test_meta_tensors_take_the_plain_version():
    q = torch.empty((2, 4, 32, 16), device='meta')
    out = ta.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape and out.device.type == 'meta'


@pytest.mark.parametrize('bad', ['dtype', 'mixed', 'kv_shape', 'ndim'])
def test_wrapper_rejects_bad_input(bad):
    q = torch.zeros(2, 8, 16)
    k = v = torch.zeros(2, 8, 16)
    if bad == 'dtype':
        q = k = v = torch.zeros(2, 8, 16, dtype=torch.float64)
    elif bad == 'mixed':
        k = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    elif bad == 'kv_shape':
        v = torch.zeros(2, 9, 16)
    elif bad == 'ndim':
        q = k = v = torch.zeros(8, 16)
    with pytest.raises((TypeError, ValueError, MXNetError)):
        ta.flash_attention(q, k, v)


def test_unsupported_head_dim_raises_on_the_card_path(monkeypatch):
    """The kernel takes D a multiple of 8 up to 128; the launch path
    refuses another D before it loads anything (no fallback)."""
    def boom(*a, **k):
        raise AssertionError('reached the kernel loader')
    monkeypatch.setattr(ta._kernels, 'load', boom)
    for d in (12, 136):
        q = torch.zeros(1, 8, d)
        with pytest.raises(MXNetError, match='multiple of 8 up to 128'):
            ta._launch(q, q, q, 1.0, True)
