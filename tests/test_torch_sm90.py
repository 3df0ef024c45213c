"""The sm90 route of the two GEMM kernels, on the CPU: which calls take
it (``gemm_route``), the tile plan the wrappers pass to the kernel
(``_sm90_plan``), and the (N, K) weight view ``fused_scale_bias_dot``
now takes.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the path-shape readers of the smoke test)

# (M, K, N) -> launches per step of fused_scale_bias_dot in the aggressive
# ResNet-50 v2 training graph at 32 rows, and of fused_dot_epilogue in the
# transformer LM's at 16 x 512 tokens
RESNET_DOTS = {
    (100352, 64, 64): 1, (100352, 64, 256): 4, (100352, 256, 64): 2,
    (100352, 256, 128): 1,
    (25088, 128, 512): 4, (25088, 256, 512): 1, (25088, 512, 128): 3,
    (25088, 512, 256): 1,
    (6272, 256, 1024): 6, (6272, 512, 1024): 1, (6272, 1024, 256): 5,
    (6272, 1024, 512): 1,
    (1568, 512, 2048): 3, (1568, 1024, 2048): 1, (1568, 2048, 512): 2}
LM_DOTS = {(8192, 512, 2048): 6}
H100_SMS = 132


def test_path_shapes_are_read_from_the_fused_graphs():
    sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=chip_smoke.IMAGE)
    dots, _, _ = chip_smoke.train_kernel_shapes(tmx, sym, chip_smoke.BATCH)
    assert dict(dots) == RESNET_DOTS
    lm, _ = chip_smoke.lm_kernel_shapes(
        tmx, chip_smoke.lm_symbol(models), chip_smoke.LM_BATCH,
        chip_smoke.LM['seq_len'])
    assert {k[:3]: v for k, v in lm.items()} == LM_DOTS


def _xw(m, k, n, dtype=torch.bfloat16, x_offset=0, w_offset=0):
    """x (M, K) and w (K, N) as the paths pass them: w is the transposed
    view of an (N, K) weight; the offsets shift either base by elements."""
    x = torch.empty(m * k + x_offset, dtype=dtype)[x_offset:].view(m, k)
    w = torch.empty(n * k + w_offset, dtype=dtype)[w_offset:].view(n, k)
    return x, w.t()


@pytest.mark.parametrize('mkn', sorted(RESNET_DOTS),
                         ids=lambda s: 'x'.join(map(str, s)))
def test_resnet_path_shapes_take_sm90(mkn):
    x, w = _xw(*mkn)
    assert fused.dot_route(x, w) == 'sm90'
    # a contiguous (K, N) w is copied to (N, K) for the kernel: sm90 too
    assert fused.dot_route(x, w.contiguous()) == 'sm90'


def test_lm_path_shape_takes_sm90():
    x, w = _xw(8192, 512, 2048)
    assert fused.epilogue_route(x, w) == 'sm90'


@pytest.mark.parametrize('case,want', [
    ('ragged', 'wmma'),          # K = 37, N = 130: TMA cannot take them
    ('n72', 'sm90'),             # K = 96, N = 72: multiples of 8
    ('f32', 'simt'),
    ('x_misaligned', 'wmma'),    # x's base 2 bytes off 16
    ('w_misaligned', 'wmma'),    # the (N, K) weight's base off 16
    ('x_noncontig', ValueError),
    ('f64', TypeError),
])
@pytest.mark.parametrize('kernel', ['dot', 'epilogue'])
def test_route_rule_off_the_path(kernel, case, want):
    route = fused.dot_route if kernel == 'dot' else fused.epilogue_route
    shape = {'ragged': (1001, 37, 130), 'n72': (256, 96, 72)}.get(
        case, (256, 64, 128))
    x, w = _xw(*shape, dtype={'f32': torch.float32,
                              'f64': torch.float64}.get(case,
                                                        torch.bfloat16),
               x_offset=int(case == 'x_misaligned'),
               w_offset=int(case == 'w_misaligned'))
    if case == 'x_noncontig':
        x = torch.empty(shape[1], shape[0], dtype=torch.bfloat16).t()
    if isinstance(want, str):
        assert route(x, w) == want
    else:
        with pytest.raises(want):
            route(x, w)


def test_gemm_route_is_a_pure_rule():
    bf16 = torch.bfloat16
    assert fused.gemm_route(bf16, 64, 256, (0, 4096, 1 << 20)) == 'sm90'
    assert fused.gemm_route(bf16, 64, 256, (0, 8)) == 'wmma'
    assert fused.gemm_route(bf16, 60, 256, (0, 0)) == 'wmma'
    assert fused.gemm_route(bf16, 64, 252, (0, 0)) == 'wmma'
    assert fused.gemm_route(torch.float32, 64, 256, (8,)) == 'simt'


def _tiles_of(m, n, bn, grid):
    """The (row, column) tiles the persistent blocks of hopper_gemm.cuh
    visit: block b takes tiles b, b + grid, ..., row tiles outer."""
    n_tiles = -(-n // bn)
    tiles = -(-m // 128) * n_tiles
    seen = [t for b in range(grid) for t in range(b, tiles, grid)]
    return [(t // n_tiles, t % n_tiles) for t in seen]


@pytest.mark.parametrize('mkn', sorted(RESNET_DOTS) + sorted(LM_DOTS),
                         ids=lambda s: 'x'.join(map(str, s)))
def test_sm90_plan_at_the_path_shapes(mkn):
    m, _, n = mkn
    bn, stages, grid = fused._sm90_plan(m, n, H100_SMS)
    # a legal wgmma width (m64nNk16: N a multiple of 8 up to 256) that
    # the epilogue's 64-column chunks divide
    assert bn in (64, 128, 256)
    assert 2 <= stages <= 8
    assert fused._sm90_smem(bn, stages) <= fused.SM90_SMEM_LIMIT == 232448
    assert 1 <= grid <= H100_SMS
    # the tiles cover M x N exactly once
    tiles = _tiles_of(m, n, bn, grid)
    assert len(tiles) == len(set(tiles))
    covered = np.zeros((m, n), dtype=np.int8)
    for r, c in tiles:
        covered[r * 128:(r + 1) * 128, c * bn:(c + 1) * bn] += 1
    assert covered.min() == 1 and covered.max() == 1
    # about a wave of tiles (7/10 of the SMs) where the shape allows one,
    # at the widest such tile
    if -(-m // 128) * -(-n // 64) * 10 >= 7 * H100_SMS:
        assert len(tiles) * 10 >= 7 * H100_SMS
    if bn < 256 and bn < n:
        assert -(-m // 128) * -(-n // (2 * bn)) * 10 < 7 * H100_SMS


def test_sm90_plan_widths_and_stages():
    assert fused._sm90_plan(8192, 2048, H100_SMS) == (256, 4, 132)
    # N = 72 fits no wider than 128; too few rows for a wave: BN = 64
    assert fused._sm90_plan(256, 72, H100_SMS) == (64, 8, 4)
    assert fused._sm90_plan(100352, 64, H100_SMS)[0] == 64
    assert fused._sm90_plan(100352, 128, H100_SMS)[:2] == (128, 6)
    # 13 row tiles: 104 tiles of 256 are about a wave at N = 2048; at
    # N = 512 only 64-wide tiles give one
    assert fused._sm90_plan(1568, 2048, H100_SMS) == (256, 4, 104)
    assert fused._sm90_plan(1568, 512, H100_SMS) == (64, 8, 104)
    assert fused._sm90_plan(6272, 256, H100_SMS) == (128, 6, 98)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dot_transposed_view_equals_contiguous_call(dtype):
    rng = np.random.RandomState(5)
    m, k, n = 40, 24, 16
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dtype)
    wnk = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(dtype)
    s = torch.from_numpy(rng.rand(k).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(k).astype(np.float32))
    before = fused.fused_scale_bias_dot.launches
    view = fused.fused_scale_bias_dot(x, wnk.t(), s, b, relu=True)
    copy = fused.fused_scale_bias_dot(x, wnk.t().contiguous(), s, b,
                                      relu=True)
    assert torch.equal(view, copy)
    assert fused.fused_scale_bias_dot.launches == before


def test_dot_transposed_view_gradients_match_contiguous():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(12, 8).astype(np.float32))
    wnk = torch.from_numpy(rng.randn(5, 8).astype(np.float32))
    s = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    grads = []
    for make in (lambda w: w.t(), lambda w: w.t().contiguous()):
        w = wnk.clone().requires_grad_(True)
        fused.fused_scale_bias_dot(x, make(w), s, b, relu=True).sum() \
            .backward()
        grads.append(w.grad)
    assert torch.equal(grads[0], grads[1])


def test_launches_by_route_counts_only_card_launches():
    for kernel in (fused.fused_scale_bias_dot, fused.fused_dot_epilogue):
        assert set(kernel.launches_by_route) == set(fused.ROUTES)
    before = dict(fused.fused_dot_epilogue.launches_by_route)
    x, w = torch.ones(4, 8), torch.ones(6, 8).t()
    fused.fused_dot_epilogue(x, w, None, relu=True)
    assert fused.fused_dot_epilogue.launches_by_route == before


def test_fused_graph_passes_the_weight_view(monkeypatch):
    """The 1x1 lowering hands the kernel the (C, F) transposed view of
    the (F, C, 1, 1) weight, no per-call copy."""
    seen = []
    orig = fused.fused_scale_bias_dot

    def spy(x, w, scale, bias, relu=False):
        seen.append((w.is_contiguous(), w.t().is_contiguous()))
        return orig(x, w, scale, bias, relu)

    from mxnet_tpu_torch import fuse
    rng = np.random.RandomState(7)
    data = torch.from_numpy(rng.randn(2, 8, 4, 4).astype(np.float32))
    ins = [data, torch.ones(8), torch.zeros(8),
           torch.from_numpy(rng.randn(16, 8, 1, 1).astype(np.float32)),
           torch.zeros(8), torch.ones(8)]
    attrs = {'kernel': (1, 1), 'stride': (1, 1), 'num_filter': 16,
             'eps': 1e-5, 'fix_gamma': False}
    monkeypatch.setattr(fuse, 'fused_scale_bias_dot', spy)
    (y,), _ = fuse._bn_relu_conv_apply(attrs, ins, True, None)
    assert seen == [(False, True)]
    assert y.shape == (2, 16, 4, 4)
