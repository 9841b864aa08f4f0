"""The serving plans of the CAT token loop (`models/serving_plan.py`,
`models/gpt.py`'s `sample_loop`) on the CPU, where a plan keeps its
prepared weights and buffers but no graph: a kept plan gives the tokens of
calls that build anew, from the same generator state, on each route; an
update of the parameters in place drops it; the keys, the least recently
used plan dropped at the fifth, the calls that run without a plan, the
trainer's preview and the `serving.*` counters. The card's side (a kept
graph replayed, the draws moved through the plan's own generator) is
`-m card` below. This file imports no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from favae_tpu_torch import config as tcfg
from favae_tpu_torch import graphs, profiling
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.models import serving_plan
from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                  sample_tokens)
from favae_tpu_torch.ops.decode_step_kernel import prepare_fused_decode

# a width every route takes (tests/test_torch_port_sample_routes.py's)
GATE = dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2, dim_head=64,
            n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
            dropout=0.0)
ROUTES = ("exact", "qparams", "fused")
PREPARE = {"qparams": quantize_decode_params,
           "fused": lambda gpt: prepare_fused_decode(gpt, gpt.cfg)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt(seed=0, device="cpu"):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = tgpt.GPT(tcfg.GPTConfig(**GATE), dtype=torch.bfloat16).eval()
    return gpt.to(device)


def _inputs(seed, device="cpu"):
    rng = np.random.RandomState(seed)
    te = torch.from_numpy(rng.randn(4, 7, 32).astype(np.float32))
    tm = torch.from_numpy(rng.rand(4, 7) > 0.2)
    tm[:, 0] = True
    return te.to(device), tm.to(device)


def _sample(gpt, route, inputs, generator, **kw):
    """`sample_tokens` on `route` as `CATModel.sample_images` calls it:
    an int8 route's prepared weights from the GPT's serving plans."""
    if route != "exact":
        kw[route] = serving_plan.weights(gpt, route,
                                         lambda: PREPARE[route](gpt))
    kw = {"top_k": 8, "top_p": 0.9, **kw}
    return sample_tokens(gpt.cfg, gpt, *inputs, generator=generator, **kw)


def _kept(gpt):
    """The GPT's store as it stands (`serving_plan.store` would restamp)."""
    return gpt.__dict__.get("_serving_plans", serving_plan.Store())


def _serving():
    return {k.split(".")[1]: v for k, v in profiling.counters().items()
            if k.startswith("serving.")}


def _moved(before):
    return {k: v - before[k] for k, v in _serving().items()}


@pytest.mark.parametrize("route", ROUTES)
def test_a_kept_plan_gives_the_tokens_of_calls_built_anew(route):
    """Two requests through one plan (a build, then a hit that copies the
    second request's context in) against the same two requests on a GPT
    of the same weights whose plans are dropped before each: the same
    tokens, and the generator left in the same state."""
    kept, anew = _gpt(), _gpt()
    requests = [_inputs(1), _inputs(2)]
    gen_kept = torch.Generator().manual_seed(5)
    gen_anew = torch.Generator().manual_seed(5)
    before = _serving()
    got = [_sample(kept, route, r, gen_kept) for r in requests]
    assert _moved(before) == {"plan_builds": 1, "plan_hits": 1,
                              "plan_drops": 0}
    want = []
    for r in requests:
        serving_plan.drop(anew)
        want.append(_sample(anew, route, r, gen_anew))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])
    assert torch.equal(gen_kept.get_state(), gen_anew.get_state())


@pytest.mark.parametrize("update", ["add_", "load_state_dict", "replaced"])
def test_an_update_in_place_drops_the_plan(update):
    """An `add_` on one weight (the first cross-attention's K/V
    projection, whose cast a plan keeps), `load_state_dict` (which copies
    in place) or that weight replaced by another parameter changes the
    stamp: the next call drops the stale plan and its casts, builds anew
    and gives a fresh model's tokens (greedy, where these widths' near-flat
    logits let the change show)."""
    gpt = _gpt()
    request = _inputs(1)
    stale = _sample(gpt, "exact", request, None, top_k=1)
    dense = gpt.blocks[0].cross_attn.to_kv[1]
    with torch.no_grad():
        if update == "add_":
            dense.weight.add_(0.5)
        elif update == "replaced":
            dense.weight = torch.nn.Parameter(dense.weight + 0.5)
        else:
            gpt.load_state_dict(_gpt(seed=1).state_dict())
    before = _serving()
    got = _sample(gpt, "exact", request, None, top_k=1)
    assert _moved(before) == {"plan_builds": 1, "plan_hits": 0,
                              "plan_drops": 1}
    fresh = copy.deepcopy(gpt)
    assert not _kept(fresh).plans   # a copy keeps no plan
    assert torch.equal(got, _sample(fresh, "exact", request, None, top_k=1))
    assert not torch.equal(got, stale)


def test_greedy_and_sampled_settings_build_two_plans():
    """cat-gen's two keys: greedy (top-k 1) and sampled requests build a
    plan each, and each later request of either is a hit."""
    gpt = _gpt()
    before = _serving()
    for top_k in (1, 500, 1, 500, 500):
        _sample(gpt, "exact", _inputs(top_k), torch.Generator(),
                top_k=top_k)
    assert _moved(before) == {"plan_builds": 2, "plan_hits": 3,
                              "plan_drops": 0}
    assert len(_kept(gpt).plans) == 2


def test_the_fifth_key_drops_the_least_recently_used():
    """Four keys kept; key 1 used again, so the fifth drops key 2, the one
    used least recently, and key 1 is still a hit."""
    gpt = _gpt()
    request = _inputs(1)

    def call(top_k):
        before = _serving()
        _sample(gpt, "exact", request, torch.Generator(), top_k=top_k)
        return _moved(before)

    for top_k in (1, 2, 3, 4):
        assert call(top_k)["plan_builds"] == 1
    assert call(1)["plan_hits"] == 1
    assert call(5) == {"plan_builds": 1, "plan_hits": 0, "plan_drops": 1}
    assert len(_kept(gpt).plans) == serving_plan.MAX_PLANS
    assert call(1)["plan_hits"] == 1
    assert call(2) == {"plan_builds": 1, "plan_hits": 0, "plan_drops": 1}


@pytest.mark.parametrize("hook", ["gumbel_noise", "forced_tokens",
                                  "return_logits"])
def test_the_audit_hooks_run_without_a_plan(hook):
    """A call with the noise or an audit hook builds no plan and finds
    none, on every route, even with the prepared weights the plans keep:
    it casts its weights anew and keeps none of them."""
    rng = np.random.RandomState(3)
    kw = {"gumbel_noise": torch.from_numpy(
              rng.gumbel(size=(16, 4, 64)).astype(np.float32)),
          "forced_tokens": torch.from_numpy(rng.randint(0, 64, (4, 16))),
          "return_logits": True}
    for route in ROUTES:
        gpt = _gpt()
        before = _serving()
        _sample(gpt, route, _inputs(1), torch.Generator(),
                **{hook: kw[hook]})
        assert _moved(before) == {"plan_builds": 0, "plan_hits": 0,
                                  "plan_drops": 0}
        assert not _kept(gpt).plans
        assert set(_kept(gpt).weights) <= {route}


def test_a_callers_own_prepared_weights_run_without_a_plan():
    gpt = _gpt()
    before = _serving()
    for route in ("qparams", "fused"):
        sample_tokens(gpt.cfg, gpt, *_inputs(1), top_k=8,
                      generator=torch.Generator(),
                      **{route: PREPARE[route](gpt)})
    assert _moved(before)["plan_builds"] == 0
    assert not _kept(gpt).plans


def _tiny_cat_cfg():
    C = tcfg
    vq = C.VQGANConfig(
        codec=C.codec_for_downsample_factor(16, z_channels=32,
                                            base_channels=32, resolution=64,
                                            num_groups=8),
        quantizer=C.QuantizerConfig(codebook_size=64, dim=32,
                                    use_cosine_sim=True),
        discriminator=C.DiscriminatorConfig(base_channels=32),
        fcm_kind="res", dsl_mode="pair", compute_dtype="float32")
    gpt = C.GPTConfig(vocab_size=64, n_layer=2, n_embed=64, n_head=4,
                      dim_head=16, n_cond_embed=32, image_encoded_dim=4,
                      max_text_len=8, dropout=0.0, remat="none")
    clip = C.CLIPTextConfig(context_length=8, vocab_size=600, width=32,
                            heads=2, layers=2, embed_dim=32)
    return C.CATConfig(vqgan=vq, clip=clip, gpt=gpt, epochs=1,
                       warmup_epochs=0)


def test_the_trainers_preview_leaves_no_plan(tmp_path):
    """`CATTrainer`'s preview samples through a plan (built: the training
    steps change the GPT between two previews) and drops it after, with
    the weights it kept (`CATModel.drop_plans`)."""
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    trainer = CATTrainer(_tiny_cat_cfg(), str(tmp_path), steps_per_epoch=1,
                         batch_size=2, device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        1, 600, (2, 8))).long()
    images = torch.zeros((2, 64, 64, 3))
    before = _serving()
    trainer._log_samples("val", (images, ["a", "b"]), (images, ids), step=0,
                         n=2)
    assert _moved(before) == {"plan_builds": 1, "plan_hits": 0,
                              "plan_drops": 1}
    gpt = trainer.cat.gpt
    assert not _kept(gpt).plans and not _kept(gpt).weights


def test_serving_counters_count_builds_hits_and_drops():
    """`profiling.counters()`' `serving.*`: a build, a hit, and the plan
    dropped by `serving_plan.drop`."""
    gpt = _gpt()
    before = _serving()
    for _ in range(2):
        _sample(gpt, "exact", _inputs(1), torch.Generator())
    serving_plan.drop(gpt)
    assert _moved(before) == {"plan_builds": 1, "plan_hits": 1,
                              "plan_drops": 1}
    assert not _kept(gpt).plans


# ---------------------------------------------------------------------------
# on the card (python -m pytest tests/test_torch_port_serving_plan.py
# -m card --noconftest)

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_serving_plan.py -m card "
                    "--noconftest)")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_a_kept_graph_draws_as_a_graph_captured_anew(card, route):
    """On the card: a request replayed for every token on a kept plan's
    graphs (the refill's, then the token step's), its draws moved
    through the plan's own generator, against the same requests each built
    anew (eager first token, captures, replays): the same tokens bit for
    bit, and the caller's generator left at the same offset."""
    kept, anew = _gpt(device=card), _gpt(device=card)
    requests = [_inputs(1, card), _inputs(2, card)]
    gen_kept = torch.Generator(card).manual_seed(5)
    gen_anew = torch.Generator(card).manual_seed(5)
    captures = graphs.STATS["captures"]
    got = [_sample(kept, route, r, gen_kept) for r in requests]
    assert graphs.STATS["captures"] - captures == 2   # step and refill
    want = []
    for r in requests:
        serving_plan.drop(anew)
        want.append(_sample(anew, route, r, gen_anew))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])
    assert gen_kept.get_offset() == gen_anew.get_offset() > 0
    assert torch.equal(gen_kept.get_state(), gen_anew.get_state())


# a request of each gen cell, at its configuration: 4 prompts (8 CFG rows)
# of 256 tokens; the launches of one request (PERF.md, section 3)
CELLS = {
    "cat-gen": ("gpt2_medium", "exact",
                {"add_ln": 24_832, "mqa_decode": 12_288,
                 "rows_gemm": 43_008}),
    "cat-gen-int8": ("gpt2_medium", "fused", {"decode_step": 256}),
    "cat-gen-large-ffn": ("gpt2_large", "qparams",
                          {"ffn_int8": 9_216, "add_ln": 27_904,
                           "mqa_decode": 18_432, "rows_gemm": 46_080}),
}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_second_request_replays_the_kept_graph(card, cell):
    """A request of the cell twice on one GPT: the first captures the
    token step and the refill (cross K/V, caches and state) and replays the
    token step 255 times; the second captures nothing, replays the refill
    once and the token step 256 times; both launch the kernels a request
    launched before plans were kept."""
    name, route, want = CELLS[cell]
    cfg = getattr(tcfg, name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[card]), torch.device(card):
        torch.manual_seed(0)
        gpt = tgpt.GPT(cfg, dtype=torch.bfloat16).eval().to(card)
    rng = np.random.RandomState(0)
    te = torch.from_numpy(rng.randn(4, 77, 768).astype(np.float32)).to(card)
    tm = torch.from_numpy(rng.rand(4, 77) > 0.3).to(card)
    gen = torch.Generator(card).manual_seed(1)
    seen = []
    for _ in range(2):
        launches = [dict(c) for c in graphs.launch_counts()]
        stats = dict(graphs.STATS)
        _sample(gpt, route, (te, tm), gen, top_k=500, top_p=0.95)
        torch.cuda.synchronize()
        moved = {k: v - b[k] for c, b in zip(graphs.launch_counts(), launches)
                 for k, v in c.items() if v != b[k]}
        seen.append((graphs.STATS["captures"] - stats["captures"],
                     graphs.STATS["replays"] - stats["replays"], moved))
    assert seen[0][:2] == (2, 255) and seen[1][:2] == (0, 1 + 256)
    assert seen[0][2] == seen[1][2]
    assert {k: seen[1][2].get(k, 0) for k in want} == want
