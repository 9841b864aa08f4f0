"""favae_tpu_torch's int8 kernel modules against the JAX package's Pallas
kernels, on the CPU.

On the CPU the port's wrappers (`matmul_int8`, `ffn_block_int8`,
`decode_step_fused`) take their plain PyTorch versions; these are held
against the TPU kernels run in interpret mode on the same seeded numpy
inputs. Prepared int8 weights must be equal to JAX's, scales and colsum
corrections equal to 1e-6. The CUDA kernels themselves run only on the card,
where chip_smoke.py holds each against its plain version.

Tolerance of the kernel outputs (bf16): both sides round at the same places
(activations to bf16 before each product, one rounding at the store) and
differ in the order of their f32 sums, which can move a value across a bf16
rounding boundary. So an output may differ by one bf16 rounding of itself
(2^-7 relative) plus, where roundings upstream flipped and spread over a row,
2^-7 of the largest output.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu.config import GPTConfig as JaxGPTConfig
from favae_tpu.models.gpt import GPT as JaxGPT
from favae_tpu.ops import decode_step_kernel as jdk
from favae_tpu.ops.ffn_int8 import ffn_block_int8 as jax_ffn_block_int8
from favae_tpu.ops.ffn_int8 import prepare_ffn_weights as jax_prepare_ffn
from favae_tpu.ops.int8_matmul import matmul_int8 as jax_matmul_int8
from favae_tpu.ops.int8_matmul import quantize_weight as jax_quantize_weight
from favae_tpu_torch.config import GPTConfig, gpt2_large, gpt2_medium
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.ops import decode_step_kernel as dk
from favae_tpu_torch.ops import ffn_int8, int8_matmul

BF16_ULP = 2.0 ** -7
GATE = dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2, dim_head=64,
            n_cond_embed=32, image_encoded_dim=4, max_text_len=7, dropout=0.0)


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) of the same values."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).bfloat16())


def _f32(a):
    """A jax array (bf16 included) as a numpy f32 array."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_one_rounding(ours, ref, spread=BF16_ULP):
    ours, ref = ours.float().numpy(), _f32(ref)
    tol = BF16_ULP * np.abs(ref) + spread * np.abs(ref).max()
    assert (np.abs(ours - ref) <= tol).all(), np.abs(ours - ref).max()


def test_quantize_weight_equals_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                      # a zero column takes scale 1
    w[3, 11] = w[:, 11].max() * 2      # and one dominated by an outlier
    wq_ref, s_ref = jax_quantize_weight(jnp.asarray(w))
    wq, s = int8_matmul.quantize_weight(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and s.shape == (1, 40)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    assert s[0, 7] == 1.0 and int(wq.abs().max()) == 127


def test_prepare_ffn_weights_equals_jax():
    rng = np.random.RandomState(1)
    w1 = (rng.randn(64, 256) * 0.05).astype(np.float32)
    w2 = (rng.randn(256, 64) * 0.05).astype(np.float32)
    g = rng.randn(256).astype(np.float32)
    ref = jax_prepare_ffn(jnp.asarray(w1), jnp.asarray(g), jnp.asarray(w2))
    ours = ffn_int8.prepare_ffn_weights(*map(torch.from_numpy, (w1, g, w2)))
    assert set(ours) == set(ref)
    for k in ("w1q", "w2q"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    for k in ("s1", "s2", "c"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(8, 256, 1024), (3, 256, 512)])
def test_matmul_int8_plain_matches_pallas(m, k, n):
    rng = np.random.RandomState(2)
    xj, xt = _bf16(rng.randn(m, k).astype(np.float32))
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    wq, s = int8_matmul.quantize_weight(torch.from_numpy(w))
    ref = jax_matmul_int8(xj, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()),
                          interpret=True)
    for fn in (int8_matmul.matmul_int8_plain, int8_matmul.matmul_int8):
        y = fn(xt, wq, s)
        assert y.dtype == torch.bfloat16 and y.shape == (m, n)
        _assert_one_rounding(y, ref, spread=1e-5)
    y32 = int8_matmul.matmul_int8(xt, wq, s, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.bfloat16(), int8_matmul.matmul_int8(xt, wq, s))


def test_ffn_block_int8_plain_matches_pallas():
    """rows 8, K 256, F 1024, as tests/test_decode_engine.py:114."""
    rng = np.random.RandomState(3)
    rows, k, f = 8, 256, 1024
    xj, xt = _bf16(rng.randn(rows, k).astype(np.float32))
    g_in = rng.randn(k).astype(np.float32)
    g_mid = rng.randn(f).astype(np.float32)
    w1 = (rng.randn(k, f) * 0.05).astype(np.float32)
    w2 = (rng.randn(f, k) * 0.05).astype(np.float32)
    ref = jax_ffn_block_int8(
        xj, jnp.asarray(g_in),
        jax_prepare_ffn(jnp.asarray(w1), jnp.asarray(g_mid), jnp.asarray(w2)),
        interpret=True)
    prep = ffn_int8.prepare_ffn_weights(*map(torch.from_numpy,
                                             (w1, g_mid, w2)))
    for fn in (ffn_int8.ffn_block_int8_plain, ffn_int8.ffn_block_int8):
        y = fn(xt, torch.from_numpy(g_in), prep)
        assert y.dtype == torch.bfloat16 and y.shape == (rows, k)
        _assert_one_rounding(y, ref, spread=2.0 ** -9)


def test_folded_mid_layernorm_equals_the_unfolded_block():
    """inv * (h @ W2' - mu * c) against LN_mid(h) @ dequantised W2 in f64:
    the fold itself is exact algebra."""
    rng = np.random.RandomState(4)
    k, f = 32, 128
    h = torch.from_numpy(rng.randn(4, f)).double()
    g = torch.from_numpy(rng.randn(f)).double()
    w2 = torch.from_numpy(rng.randn(f, k) * 0.05).double()
    mu = h.mean(-1, keepdim=True)
    var = (h * h).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + 1e-5)
    w2f = g[:, None] * w2
    folded = inv * (h @ w2f - mu * w2f.sum(0, keepdim=True))
    plain = ((h - mu) * inv * g) @ w2
    torch.testing.assert_close(folded, plain, atol=1e-10, rtol=1e-10)


@pytest.fixture(scope="module")
def gate_models():
    """The smallest config the fused kernel's gates take
    (tests/test_decode_step_kernel.py:26), JAX params carried into the port."""
    cfg = JaxGPTConfig(**GATE)
    n = cfg.image_encoded_dim ** 2
    params = JaxGPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, n - 1), jnp.int32),
        jnp.zeros((1, 7, 32), jnp.float32), jnp.ones((1, 7), bool),
        cond_drop_prob=0.0)["params"]
    # random LayerNorm scales and null kv, so that nothing is hidden by ones
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(1 + 0.2 * rng.randn(*a.shape), a.dtype)
                         if "scale" in jax.tree_util.keystr(path) else a),
        params)
    tcfg = GPTConfig(**GATE)
    gpt = GPT(tcfg).eval()
    gpt.load_state_dict(gpt_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    return cfg, params, tcfg, gpt


def test_prepare_fused_decode_equals_jax(gate_models):
    cfg, params, tcfg, gpt = gate_models
    ref = jdk.prepare_fused_decode(params, cfg)
    ours = dk.prepare_fused_decode(gpt, tcfg)
    p = jdk.plan(cfg)
    d, inner, w = p["d"], p["inner"], p["w"]
    tiles, scales = np.asarray(ref["attn_t"]), np.asarray(ref["attn_s"])
    t = 0
    for name, sname, k, n in (("wq_s", "sq_s", d, inner),
                              ("wo_s", "so_s", inner, d),
                              ("wq_c", "sq_c", d, inner),
                              ("wo_c", "so_c", inner, d)):
        nt = n // w
        # JAX tiles are (d, w) column chunks, to_out zero-padded from inner
        # to d rows; per-column quantisation does not see the tiling
        mat = np.concatenate(list(np.moveaxis(tiles[:, t:t + nt], 1, 0)),
                             axis=-1)[:, :k]
        sc = np.concatenate(list(np.moveaxis(scales[:, t:t + nt], 1, 0)),
                            axis=-1)
        np.testing.assert_array_equal(ours[name].numpy(), mat)
        np.testing.assert_allclose(ours[sname].numpy(), sc, rtol=1e-6)
        t += nt
    for ours_k, ref_k in (("w1q", "w1q"), ("w2q", "w2q")):
        np.testing.assert_array_equal(ours[ours_k].numpy(),
                                      np.asarray(ref[ref_k]))
    for k in ("s1", "s2", "c2", "norms"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours["wkv"].float().numpy(),
                                  _f32(ref["wkv"]))
    np.testing.assert_array_equal(ours["null_s"].numpy(),
                                  np.asarray(ref["null_s"]))


@pytest.mark.parametrize("pos", [0, 1, 7, 15])
def test_decode_step_fused_plain_matches_pallas(gate_models, pos):
    """L 2, d 128, 2 x 64 heads, rows 8, S 16: x_new and the cache row
    written at `pos`, the cache filled up to there."""
    cfg, params, tcfg, gpt = gate_models
    rows, seq, m_cross = 8, 16, 8
    L, H, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    rng = np.random.RandomState(100 + pos)
    xj, xt = _bf16(rng.randn(rows, d).astype(np.float32))
    caches = rng.randn(L, rows, seq, dh).astype(np.float32)
    caches[:, :, pos:] = 0.0
    cj, ct = _bf16(caches)
    kvj, kvt = _bf16(rng.randn(L, rows, m_cross, dh).astype(np.float32))
    bias = np.where(rng.rand(rows, m_cross) > 0.3, 0.0, -1e9).astype(np.float32)
    bias[:, 0] = 0.0
    bias[rows // 2:, 1:] = -1e9        # the null-text half of a CFG batch
    rel = rng.randn(L, H, seq + 1).astype(np.float32)
    rel[..., 0] = 0.0

    x_ref, c_ref = jdk.decode_step_fused(
        xj, jnp.asarray(pos, jnp.int32), cj, kvj, jnp.asarray(bias),
        jnp.asarray(rel), jdk.prepare_fused_decode(params, cfg), cfg,
        interpret=True)
    fused = dk.prepare_fused_decode(gpt, tcfg)
    before = ct.clone()
    x_new, c_new = dk.decode_step_fused(
        xt, pos, ct, kvt, torch.from_numpy(bias), torch.from_numpy(rel),
        fused, tcfg)
    assert c_new is ct, "the cache is written in place"
    assert x_new.dtype == torch.bfloat16
    _assert_one_rounding(x_new, x_ref)
    _assert_one_rounding(ct[:, :, pos], c_ref[:, :, pos])
    keep = np.arange(seq) != pos
    assert torch.equal(ct[:, :, keep], before[:, :, keep])
    # the plain version is what the wrapper took
    x_plain, _ = dk.decode_step_fused_plain(
        xt, pos, before, kvt, torch.from_numpy(bias), torch.from_numpy(rel),
        fused, tcfg)
    assert torch.equal(x_plain, x_new)


def test_decode_step_ignores_cache_rows_beyond_pos(gate_models):
    _, _, tcfg, gpt = gate_models
    rng = np.random.RandomState(5)
    rows, seq, m_cross, pos = 8, 16, 4, 5
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, kv = t(rows, 128).bfloat16(), t(2, rows, m_cross, 64).bfloat16()
    caches = t(2, rows, seq, 64).bfloat16()
    dirty = caches.clone()
    dirty[:, :, pos + 1:] = 1e4
    args = (kv, torch.zeros(rows, m_cross), t(2, 2, seq + 1),
            dk.prepare_fused_decode(gpt, tcfg), tcfg)
    a, _ = dk.decode_step_fused(x, pos, caches, *args)
    b, _ = dk.decode_step_fused(x, pos, dirty, *args)
    assert torch.equal(a, b)


def test_supports_and_plan():
    medium = gpt2_medium(vocab_size=1024)
    large = gpt2_large(vocab_size=1024)
    assert dk.supports(medium, 8) and dk.supports(medium, 16)
    assert not dk.supports(medium, 6)        # rows not a multiple of 8
    assert not dk.supports(large, 8)         # inner 2048 > d 1280
    assert dk.supports(GPTConfig(**GATE), 8)
    assert not dk.supports(GPTConfig(**{**GATE, "dim_head": 32}), 8)
    assert not dk.supports(GPTConfig(**{**GATE, "n_embed": 96, "n_head": 1}), 8)
    p = dk.plan(medium)
    assert (p["d"], p["inner"], p["f"]) == (1536, 1024, 6144)
    for key, k in (("kc_q", 1536), ("kc_o", 1024), ("kc_1", 1536),
                   ("kc_2", 6144)):
        assert p[key] % dk.BOX_K == 0 and 0 < p[key] <= k


@pytest.mark.parametrize("k,n", [(1536, 1024), (1024, 1536), (1536, 6144),
                                 (6144, 1536), (128, 128), (100, 64)])
def test_chunk_of_k_covers_k(k, n):
    """The FFN kernel's chunks: whole boxes (fc1) or whole fc1 tiles
    (fc2), covering K, as many items as the workers allow."""
    workers = ffn_int8.WORKERS * 132
    for unit in (ffn_int8.BOX_K, ffn_int8.TILE_N):
        kc = ffn_int8.chunk_of_k(k, n, workers, unit)
        assert kc % unit == 0 and unit <= kc <= -(-k // unit) * unit
        chunks = -(-k // kc)
        assert (chunks - 1) * kc < k <= chunks * kc
        if kc > unit:          # a smaller chunk would give too many items
            assert -(-n // 128) * -(-k // (kc - unit)) > workers


def test_int8_wrappers_never_fall_back_off_the_cpu(gate_models):
    """Only CPU tensors take the plain versions; any other device must
    launch the kernel or raise."""
    _, _, tcfg, gpt = gate_models
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(*s, device="meta",
                                                        dtype=dtype)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul.matmul_int8(meta(8, 16), meta(16, 8, dtype=torch.int8),
                                meta(1, 8, dtype=torch.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        ffn_int8.ffn_block_int8(meta(8, 16), meta(16, dtype=torch.float32), {})
    with pytest.raises(ValueError, match="unsupported device"):
        dk.decode_step_fused(meta(8, 128), 0, None, None, None, None, {}, tcfg)


@pytest.mark.parametrize("module", [
    "ops.int8_matmul", "ops.ffn_int8", "ops.decode_step_kernel", "models.gpt",
    "models.clip_text", "models.decode_engine", "models.txt_cond",
    "cli.generate", "cli.profile_decode", "convert"])
def test_new_modules_import_without_triton_nvcc_or_a_gpu(module):
    importlib.import_module(f"favae_tpu_torch.{module}")
    assert "triton" not in sys.modules
    assert not torch.cuda.is_available()
    from favae_tpu_torch import _build
    assert not _build._LIBS, "importing a module must build no kernel"
