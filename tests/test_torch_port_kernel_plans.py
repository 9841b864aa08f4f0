"""Host-side plans of the redesigned kernels, and the error-compensated
TF32 product in plain PyTorch, on the CPU.

`matmul_plan` cuts (M, K) x (K, N) into column tiles, row groups and a
thread-block cluster along K; `vq_plan` cuts a codebook into runs of code
tiles. The CUDA kernels themselves run only on the card (chip_smoke.py);
what decides which block reads which rows is Python and is held here.
`vq_nearest_tf32x3_plain` is the arithmetic of the tensor-core route that
`vq_nearest`'s kernel takes (three TF32 products for one of f32): its
indices equal the f32 argmax except at near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu.ops.vq_pallas import vq_nearest_pallas
from favae_tpu_torch.ops import int8_matmul, vq

SMEM_MAX = int8_matmul.SMEM_MAX
CAT_SHAPES = [(8, 1536, 1024), (8, 1024, 1536), (8, 1536, 6144),
              (8, 6144, 1536)]
RAGGED = [(16, 1536, 6144), (2, 1536, 6144), (3, 100, 64), (40, 1000, 272),
          (8, 128, 128), (17, 30000, 48), (1, 16, 16)]


@pytest.mark.parametrize("m,k,n", CAT_SHAPES + RAGGED)
def test_matmul_plan_covers_every_k_and_column_once(m, k, n):
    p = int8_matmul.matmul_plan(m, k, n)
    tn = int8_matmul.MMA_TN
    assert p.nb == (2 if m > 8 else 1)
    assert p.ranks in (1, 2, 4, 8) and p.ranks <= int8_matmul.MAX_CLUSTER
    assert p.kc % int8_matmul.MMA_K == 0 and 0 < p.kc <= int8_matmul.MMA_KC_MAX
    ranks, tiles, groups = p.grid(m, n)
    # rank r takes rows [r kc, (r + 1) kc) of K below K: a partition
    seen = np.zeros(k, dtype=int)
    for r in range(ranks):
        seen[min(k, r * p.kc):min(k, (r + 1) * p.kc)] += 1
    assert (seen == 1).all()
    cols = np.zeros(n, dtype=int)
    for t in range(tiles):
        cols[t * tn:min(n, (t + 1) * tn)] += 1
    assert (cols == 1).all()
    rows = np.zeros(m, dtype=int)
    for g in range(groups):
        rows[g * 8 * p.nb:min(m, (g + 1) * 8 * p.nb)] += 1
    assert (rows == 1).all()
    assert p.smem() <= SMEM_MAX
    assert int8_matmul.matmul_plan(m, k, n) is p          # cached


@pytest.mark.parametrize("m,k,n", CAT_SHAPES)
def test_matmul_plan_fills_the_card_at_the_cat_shapes(m, k, n):
    p = int8_matmul.matmul_plan(m, k, n)
    ranks, tiles, groups = p.grid(m, n)
    assert ranks * tiles * groups >= 64        # half the SMs or more
    assert p.ranks == 8 and p.kc * 128 >= 8192  # a block streams >= 8 KB


def test_matmul_plan_refuses_a_k_beyond_the_cluster():
    with pytest.raises(ValueError, match="chunks"):
        int8_matmul.matmul_plan(8, 8 * int8_matmul.MMA_KC_MAX + 16, 128)


@pytest.mark.parametrize("n,k", [(4096, 1024), (4096, 16384), (512, 1024),
                                 (2048, 1024), (100, 70), (300, 1500),
                                 (65536, 1024), (1, 1)])
def test_vq_plan_covers_every_code_tile_once(n, k):
    p = vq.vq_plan(n, k)
    k_tiles = -(-k // vq._BK)
    seen = np.zeros(k_tiles, dtype=int)
    for s in range(p.splits):
        seen[s * p.tiles_per_split:(s + 1) * p.tiles_per_split] += 1
    assert (seen == 1).all()
    assert (p.splits - 1) * p.tiles_per_split < k_tiles   # no empty split
    n_tiles = -(-n // vq._BN)
    assert p.splits == 1 or n_tiles * p.splits <= vq.DEFAULT_SMS
    assert vq.vq_plan(n, k) is p                           # cached


def test_vq_plan_at_expe5_is_one_block_an_sm():
    assert vq.vq_plan(4096, 1024) == vq.VqPlan(2, 4)       # 32 x 4 blocks
    assert vq.vq_plan(65536, 1024).splits == 1             # tokens suffice


def test_round_and_cut_tf32():
    v = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      1.0 + 2 ** -10, 3.14159, 0.0])
    r = vq.round_tf32(v)
    assert r.tolist()[:4] == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                              1.0 + 2 ** -10]            # ties away from zero
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    c = vq.cut_tf32(v)
    assert c.tolist()[:3] == [1.0, -1.0, 1.0]
    assert (c.abs() <= v.abs()).all()


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _vq_inputs(metric, n, k, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    e = rng.randn(k, d).astype(np.float32)
    if metric == "cosine":
        return _unit(x), _unit(e), None
    return 2.0 * x, e, -np.sum(e * e, axis=-1)


@pytest.mark.parametrize("metric,n,k,d", [
    ("cosine", 256, 1024, 64), ("euclidean", 256, 1024, 64),
    ("cosine", 300, 1500, 32), ("euclidean", 100, 70, 16),
    ("cosine", 512, 1024, 256), ("euclidean", 129, 513, 30)])
def test_tf32x3_indices_equal_f32_argmax_outside_near_ties(metric, n, k, d):
    """Against `vq_nearest_plain` and the TPU kernel in interpret mode: a
    token may differ only where the f32 scores of the two codes are within
    1e-5 of each other."""
    x, e, bias = _vq_inputs(metric, n, k, d, seed=n + k + d)
    args = (torch.from_numpy(x), torch.from_numpy(e),
            None if bias is None else torch.from_numpy(bias))
    ours = vq.vq_nearest_tf32x3_plain(*args)
    assert ours.dtype == torch.int32
    plain = vq.vq_nearest_plain(*args)
    pallas = torch.from_numpy(np.array(vq_nearest_pallas(
        jnp.asarray(x), jnp.asarray(e),
        None if bias is None else jnp.asarray(bias), interpret=True)))
    scores = args[0] @ args[1].T
    if bias is not None:
        scores = scores + args[2]
    for ref in (plain, pallas):
        differ = ours != ref
        gap = (scores.gather(1, ref.long()[:, None])
               - scores.gather(1, ours.long()[:, None]))[:, 0].abs()
        assert (gap[differ] < 1e-5).all(), gap[differ].max()
        assert differ.float().mean() <= 0.01


def test_tf32x3_exact_ties_go_to_the_lowest_index():
    x = torch.ones(4, 8)
    e = torch.ones(6, 8)
    e[3:] *= 2.0                       # codes 3..5 tie for the best score
    assert vq.vq_nearest_tf32x3_plain(x, e).tolist() == [3, 3, 3, 3]
    bias = torch.tensor([0.0, 0.0, 0.0, -1.0, 0.0, 0.0])
    assert vq.vq_nearest_tf32x3_plain(x, e, bias).tolist() == [4, 4, 4, 4]


def test_tf32x3_scores_are_as_close_to_float64_as_f32():
    x, e, _ = _vq_inputs("cosine", 256, 512, 256, seed=9)
    xt, et = torch.from_numpy(x), torch.from_numpy(e)
    x_hi, e_hi = vq.round_tf32(xt), vq.round_tf32(et)
    x_lo, e_lo = vq.cut_tf32(xt - x_hi), vq.cut_tf32(et - e_hi)
    s3 = (x_lo @ e_hi.T + x_hi @ e_lo.T) + x_hi @ e_hi.T
    s1 = x_hi @ e_hi.T
    ref = xt.double() @ et.double().T
    assert (s3.double() - ref).abs().max() < 1e-6       # f32's own: ~2.5e-7
    assert (s1.double() - ref).abs().max() > 1e-5       # plain TF32 cannot
