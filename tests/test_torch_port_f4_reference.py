"""The port's FA-VAE at a tiny size with `imagenet_f4`'s structure (the
conv-FCM decoder whose taps are added back, its first FCM in as many
groups as the z channels, a codebook searched through a projection, the
mid blocks' attention) against the benchmark's plain reference of it
(`benchmark/reference/vqgan_conv.py`), float32 on the CPU, on seeded
random weights: the codes equal, the reconstructions within one float32
rounding of the reference's scale. A planted fault in the port (the taps
not added back, the first FCM in one group, the projection fed the latent's
channels in another order) fails the comparison. And the work counters
this configuration's cells read (`vq.macs`, `codec.attn_calls`,
`codec.attn_scores`, `decode_step.bytes`) against the shapes."""

import copy
import dataclasses

import pytest
import torch

from benchmark import favae
from benchmark.drivers.recon_proj import make_weights
from benchmark.harness import BENCH, load_json
from benchmark.reference import config as RC
from benchmark.reference.vqgan_conv import VQGANFCMConv
from favae_tpu_torch import config as PC
from favae_tpu_torch import graphs, profiling
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.models.vqgan import build_model
from favae_tpu_torch.ops import decode_step_kernel as dk
from favae_tpu_torch.ops import vq

SEED = 2 ** 33 + 4099
BATCH, RES, K, D = 2, 32, 256, 32
# the reconstructions' largest error over the reference's largest value:
# two float32 paths through ~30 layers whose sums run in another order
RECON_TOL = 1e-4


def tiny_f4() -> dict:
    cfg = copy.deepcopy(load_json(BENCH / "configs" / "imagenet_f4.json"))
    m = cfg["model"]
    # ch_mult (1, 2, 4), no attn_resolutions, z 3 in 3 groups: as published
    m["codec"].update(base_channels=32, num_res_blocks=1, resolution=RES)
    m["quantizer"].update(codebook_size=K, codebook_dim=D)
    m["discriminator"].update(base_channels=8, num_layers=2)
    m["compute_dtype"] = "float32"
    cfg["loss"]["spectral_dtype"] = "float32"
    return cfg


def port_model(cfg, **codec):
    model_cfg, loss_cfg, _ = favae.configs(PC, cfg, 0)
    if codec:
        model_cfg = dataclasses.replace(model_cfg, codec=dataclasses.replace(
            model_cfg.codec, **codec))
    model = build_model(model_cfg, "cpu",
                        gaussian_kernel=loss_cfg.gaussian_kernel,
                        dsl_init_sigma=loss_cfg.dsl_init_sigma)
    model.load_state_dict(make_weights(cfg, SEED, "cpu"))
    return model.eval()


def reference_model(cfg):
    model_cfg, loss_cfg, _ = favae.configs(RC, cfg, 0, reference=True)
    model = VQGANFCMConv(model_cfg, loss_cfg.gaussian_kernel,
                         loss_cfg.dsl_init_sigma)
    model.load_state_dict(make_weights(cfg, SEED, "cpu"))
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_f4()
    g = torch.Generator().manual_seed(7)
    x = torch.rand(BATCH, RES, RES, 3, generator=g) * 2 - 1
    ref_recon, ref_codes = reference_model(cfg).reconstruct(x)
    return cfg, x, ref_recon, ref_codes


def gaps(got, ref_recon, ref_codes):
    recon, codes = got
    err = float((recon - ref_recon).abs().max() / ref_recon.abs().max())
    return int((codes != ref_codes).sum()), err


def test_reconstruct_agrees_with_the_reference(pair):
    cfg, x, ref_recon, ref_codes = pair
    model = port_model(cfg)
    assert model.quantizer.project_in is not None
    assert model.decoder.fcm_1.block[0].num_groups == 3
    recon, codes = model.reconstruct(x)
    assert codes.shape == (BATCH, RES // 4, RES // 4)
    assert recon.shape == x.shape
    # the codes the reference chose are not near-ties it could flip
    assert len(set(ref_codes.flatten().tolist())) > 8
    mismatched, err = gaps((recon, codes), ref_recon, ref_codes)
    assert mismatched == 0
    assert err <= RECON_TOL


def _taps_not_added(model):
    def apply_fcm(h, i, taps):
        t = getattr(model.decoder, f"fcm_{i}")(h)
        taps.append(t)
        return t
    model.decoder._apply_fcm = apply_fcm


class _Rolled(torch.nn.Module):
    """A projection fed the latent's channels rolled by one."""

    def __init__(self, proj):
        super().__init__()
        self.proj = proj

    def forward(self, z):
        return self.proj(z.roll(1, dims=-1))


def _channels_swapped(model):
    model.quantizer.project_in = _Rolled(model.quantizer.project_in)


@pytest.mark.parametrize("fault", ["taps_not_added", "first_fcm_one_group",
                                   "projection_channels_swapped"])
def test_planted_fault_fails(pair, fault):
    cfg, x, ref_recon, ref_codes = pair
    if fault == "first_fcm_one_group":
        model = port_model(cfg, num_groups=1)
    else:
        model = port_model(cfg)
        {"taps_not_added": _taps_not_added,
         "projection_channels_swapped": _channels_swapped}[fault](model)
    mismatched, err = gaps(model.reconstruct(x), ref_recon, ref_codes)
    assert mismatched > 0 or err > 100 * RECON_TOL
    if fault == "projection_channels_swapped":
        assert mismatched > 0


def _delta(fn):
    before = profiling.counters()
    fn()
    after = profiling.counters()
    return {k: after[k] - before[k] for k in after}


def test_reconstruct_counts_its_search_and_attention(pair):
    cfg, x, _, _ = pair
    model = port_model(cfg)
    got = _delta(lambda: model.reconstruct(x))
    n, length = BATCH * (RES // 4) ** 2, (RES // 4) ** 2
    assert got["vq.macs"] == n * K * D
    # one mid-block attention in the encoder and one in the decoder
    assert got["codec.attn_calls"] == 2
    assert got["codec.attn_scores"] == 2 * BATCH * length ** 2
    # no kernel on the CPU
    assert got["launches.vq_nearest"] == 0


def test_decode_codes_count_one_attention(pair):
    cfg, _, _, ref_codes = pair
    model = port_model(cfg)
    got = _delta(lambda: model.decode_code(ref_codes))
    assert got["vq.macs"] == 0
    assert got["codec.attn_calls"] == 1
    assert got["codec.attn_scores"] == BATCH * (RES // 4) ** 4


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.fixture(scope="module")
def tiny_step():
    cfg = PC.GPTConfig(vocab_size=64, n_layer=2, n_embed=128, n_head=2,
                       dim_head=64, n_cond_embed=64, image_encoded_dim=4,
                       max_text_len=7, dropout=0.0)
    torch.manual_seed(0)
    fused = dk.prepare_fused_decode(GPT(cfg).eval(), cfg)
    rows, seq, m = 8, cfg.image_encoded_dim ** 2, 8
    L, dh = cfg.n_layer, cfg.dim_head
    g = torch.Generator().manual_seed(1)
    x = torch.randn(rows, cfg.n_embed, generator=g).bfloat16()
    caches = torch.zeros(L, rows, seq, dh, dtype=torch.bfloat16)
    cross_kv = torch.randn(L, rows, m, dh, generator=g).bfloat16()
    cross_bias = torch.zeros(rows, m)
    rel_rows = torch.randn(L, cfg.n_head, seq + 1, generator=g)
    fixed = (2 * _nbytes(x) + _nbytes(cross_kv, cross_bias, rel_rows)
             + _nbytes(*fused.values()))
    return cfg, (x, caches, cross_kv, cross_bias, rel_rows, fused), fixed


@pytest.mark.parametrize("pos", [0, 5, "tensor"])
def test_decode_step_counts_the_bytes_it_streams(tiny_step, pos):
    cfg, (x, caches, *rest), fixed = tiny_step
    L, rows, seq, dh = caches.shape
    at = torch.tensor(3) if pos == "tensor" else pos
    got = _delta(lambda: dk.decode_step_fused(x, at, caches.clone(), *rest,
                                              cfg=cfg))
    # the cache's rows up to the position; a device position at the mean
    # of a sweep over all S of them
    cache_rows = (seq + 1) / 2 if pos == "tensor" else pos + 1
    assert got["decode_step.bytes"] == fixed + L * rows * dh * 2 * cache_rows
    assert got["launches.decode_step"] == 0


def test_decode_step_bytes_at_gpt2_medium():
    """Row 6's bound: 0.185 ms at gpt2_medium, 8 rows, S 256, the text's 77
    tokens and the null, position 255."""
    cfg = PC.gpt2_medium(vocab_size=1024, n_cond_embed=768)
    L, d, inner, f, dh = (cfg.n_layer, cfg.n_embed, cfg.n_head * cfg.dim_head,
                          4 * cfg.n_embed, cfg.dim_head)
    rows, seq, m = 8, 256, 78
    shapes = {"wq_s": (d, inner), "wo_s": (inner, d), "wq_c": (d, inner),
              "wo_c": (inner, d), "w1q": (d, f), "w2q": (f, d),
              "wkv": (d, dh), "sq_s": (1, inner), "so_s": (1, d),
              "sq_c": (1, inner), "so_c": (1, d), "s1": (1, f), "s2": (1, d),
              "c2": (1, d), "null_s": (1, dh), "norms": (5, d)}
    meta = dict(device="meta")
    fused = {k: torch.empty((L,) + s, dtype=dk._FUSED_DTYPES.get(
        k, torch.float32), **meta) for k, s in shapes.items()}
    nbytes = dk.step_bytes(
        torch.empty(rows, d, dtype=torch.bfloat16, **meta), 255,
        torch.empty(L, rows, seq, dh, dtype=torch.bfloat16, **meta),
        torch.empty(L, rows, m, dh, dtype=torch.bfloat16, **meta),
        torch.empty(rows, m, **meta), torch.empty(L, cfg.n_head, seq + 1,
                                                   **meta), fused)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.185, rel=0.02)


def test_graph_counts_keep_the_work_counters_per_replay():
    """A capture's work is undone and added once a replay, as its
    launches are."""
    before = (vq.WORK["macs"], dk.WORK["bytes"])

    def capture():
        vq.WORK["macs"] += 10
        dk.WORK["bytes"] += 2.5

    taken = graphs.counts_of(capture)
    assert (vq.WORK["macs"], dk.WORK["bytes"]) == before
    for _ in range(3):
        graphs.add_counts(taken)
    assert vq.WORK["macs"] == before[0] + 30
    assert dk.WORK["bytes"] == before[1] + 7.5
