"""The GroupNorm backward's first pass (`ops/gn.py::gn_bwd_sums`, kernel
`csrc/gn_bwd_sums.cu`) on the CPU.

The kernel runs only on the card (`chip_smoke.py::check_gn_bwd`). Which
block reads which rows, and which of them arrive by bulk copy, is decided by
`bwd_sums_plan` and cut by `block_pieces`, the Python copy of the kernel's
`block_range`: the first tests hold that copy to the kernel's needs at the
shapes a celebahq_expe5 train step gives it, at imagenet_f4's 3 channels in
3 groups and at odd H*W. The others hold the plain composition that the CPU
takes (`gn_bwd_sums_fold_plain`: the sums, then `gn_bwd_fold`) against the
JAX package's `_gn_act_fwd` / `_gn_act_bwd` in interpret mode, and against
finite differences in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu.ops.gn_pallas import _gn_act_bwd, _gn_act_fwd
from favae_tpu_torch.ops import gn

SMS = 132
# (N, C, H, W) of every GroupNorm backward of a celebahq_expe5 train step at
# batch 16 (the census of chip_smoke.py), imagenet_f4's first conv-FCM
# GroupNorm, and odd H*W with C % 8 != 0
CENSUS = [(16, 128, 256, 256), (16, 128, 128, 128), (16, 256, 128, 128),
          (16, 256, 64, 64), (16, 256, 32, 32), (16, 512, 32, 32),
          (16, 512, 16, 16), (16, 256, 16, 16), (16, 128, 64, 64)]
ODD = [(2, 3, 64, 64), (2, 64, 5, 5), (3, 3, 5, 5), (5, 12, 7, 3),
       (2, 6, 9, 9), (1, 2048, 3, 3)]
# itemsizes of x and dy: bf16 (the train step's), f32, and mixed
SIZES = [(2, 2), (4, 4), (2, 4)]


def _pieces(n, hw, c, plan):
    return [(blk, kind, r, k) for blk in range(plan.blocks)
            for kind, r, k in gn.block_pieces(plan, n, blk, hw, c)]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("shape", CENSUS + ODD)
def test_plan_covers_every_row_once_with_aligned_bulk_copies(shape, sizes):
    n, c, h, w = shape
    hw = h * w
    plan = gn.bwd_sums_plan(n, hw, c, *sizes, sms=SMS)
    align = gn.bwd_align_rows(c)
    assert (align == 1) == (c % 8 == 0)
    assert 1 <= plan.blocks <= gn.BWD_MAX_BLOCKS
    assert plan.stage_rows % align == 0
    row_bytes = c * sum(sizes)
    # the ring, then the fold's constants (scale, inv and mean: 3 C floats)
    assert gn.BWD_STAGES * plan.stage_rows * row_bytes <= plan.fold_at
    unit = 8 if c % 8 == 0 else 1
    assert 2 * gn.BWD_CONSUMERS * unit * 4 <= plan.fold_at  # row group sums
    assert 2 * c * 4 <= plan.fold_at  # the last block's sums
    assert plan.fold_at % 4 == 0 and plan.fold_at + 3 * c * 4 == plan.smem
    assert plan.smem <= gn.BWD_SMEM_MAX
    for i in range(n) if n <= 3 else (0, 1, n - 1):
        seen = np.zeros(hw, dtype=np.int32)
        for blk, kind, r, k in _pieces(i, hw, c, plan):
            assert k > 0 and 0 <= r and r + k <= hw
            assert blk * plan.rows_per_block <= r
            assert r + k <= (blk + 1) * plan.rows_per_block
            seen[r:r + k] += 1
            if kind == "bulk":
                assert k <= plan.stage_rows and k % align == 0
                for size in sizes:
                    assert (i * hw + r) * c * size % 16 == 0, (kind, r)
                    assert k * c * size % 16 == 0, (kind, k)
                assert k * row_bytes < 1 << 20  # an mbarrier's tx count
            else:
                assert kind in ("head", "tail") and k < align
        assert (seen == 1).all(), i


@pytest.mark.parametrize("shape", CENSUS)
def test_plan_keeps_partials_small_and_the_grid_full(shape):
    """A train step's shapes: at most 64 KB of partials an image for its
    last block to add up, and at least one block an SM where the image is
    large enough to give every block 64 KB."""
    n, c, h, w = shape
    plan = gn.bwd_sums_plan(n, h * w, c, 2, 2, sms=SMS)
    assert plan.blocks * 2 * c * 4 <= 64 * 1024
    if h * w * c * 4 >= gn.BWD_MAX_BLOCKS * gn.BWD_MIN_BLOCK_BYTES:
        assert n * plan.blocks >= SMS
    # the vector path: no row by ordinary loads
    assert all(kind == "bulk" for _, kind, _, _ in
               _pieces(n - 1, h * w, c, plan))


def test_plan_tail_and_head_rows_at_odd_shapes():
    # 3 channels of bf16 are 6-byte rows: 8 rows make 48 bytes
    plan = gn.bwd_sums_plan(3, 25, 3, 2, 2, sms=SMS)
    assert gn.bwd_align_rows(3) == 8 and plan.blocks == 1
    assert gn.block_pieces(plan, 0, 0, 25, 3) == [("bulk", 0, 24),
                                                  ("tail", 24, 1)]
    # image 1 starts at row 25: 7 rows by ordinary loads up to row 32
    assert gn.block_pieces(plan, 1, 0, 25, 3) == [("head", 0, 7),
                                                  ("bulk", 7, 16),
                                                  ("tail", 23, 2)]
    assert gn.block_pieces(plan, 2, 0, 25, 3) == [("head", 0, 6),
                                                  ("bulk", 6, 16),
                                                  ("tail", 22, 3)]


def _case(n, c, h, w, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, c) * 2.0 + 0.5).astype(np.float32)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    dy = rng.randn(n, h, w, c).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,groups", [(128, 32), (3, 3)])
def test_backward_matches_pallas(c, groups, act):
    """dx, dscale and dbias of the port's Function (the CPU takes
    gn_bwd_sums' plain composition) against the TPU kernels' forward and
    backward in interpret mode on the same inputs; f32, atol 1e-4 as
    test_group_norm_act_grads_match_pallas."""
    x, scale, bias, dy = _case(2, c, 8, 8, seed=c + groups)
    f32 = jnp.dtype(jnp.float32)
    _, res = _gn_act_fwd(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), groups, 1e-5, act, f32, True)
    ref = _gn_act_bwd(groups, 1e-5, act, f32, True, res, jnp.asarray(dy))

    ins = [_nchw(x).requires_grad_(), torch.from_numpy(scale).requires_grad_(),
           torch.from_numpy(bias).requires_grad_()]
    y = gn.group_norm_act(*ins, groups, act=act)
    ours = torch.autograd.grad(y, ins, _nchw(dy))
    for o, r, what in ((ours[0].permute(0, 2, 3, 1), ref[0], "dx"),
                       (ours[1], ref[1], "dscale"), (ours[2], ref[2], "dbias")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("act", [None, "silu"])
def test_backward_gradcheck_three_channels_in_three_groups(act):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=g)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    scale = torch.randn(3, dtype=torch.float64, generator=g).requires_grad_()
    bias = torch.randn(3, dtype=torch.float64, generator=g).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: gn.group_norm_act(x, s, b, 3, act=act),
        (x, scale, bias))


def test_sums_fold_plain_is_the_sums_then_the_fold():
    """gn_bwd_sums on the CPU gives the per-image sums whose sum over images
    is (dbias, dscale), and c2, c3 as gn_bwd_fold makes them."""
    x, scale, bias, dy = _case(3, 64, 5, 5, seed=9)
    xt, dyt = _nchw(x), _nchw(dy)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    a, b, mean, inv = gn.gn_affine(gn.gn_stats_plain(xt), st, bt, 16, 25,
                                   1e-5)
    out = gn.gn_bwd_sums(xt, dyt, a, b, st, mean, inv, "silu")
    assert out.sums.shape == (3, 2, 64)
    torch.testing.assert_close(out.dbias, out.sums[:, 0].sum(0))
    torch.testing.assert_close(out.dscale, out.sums[:, 1].sum(0))
    p = inv.expand(-1, -1, 4).reshape(3, 64)
    q = (-mean * inv).expand(-1, -1, 4).reshape(3, 64)
    sums = gn.gn_bwd_sums_plain(xt, dyt, a, b, p, q, "silu")
    for o, r in zip(out[:4], gn.gn_bwd_fold(sums, st, mean, inv, 25)):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
