"""The port's spans and counters (`favae_tpu_torch.profiling`): no
profiler, no range; under `torch.profiler` the codec's, the serving loop's
and the loader's stages as `favae:` ranges in order; the loader's counters
on the thread and the process paths; `counters()` holding every group.
On the CPU only, but for `run_steps`' graph counters, which need a card
(`python -m pytest tests/test_torch_port_tracing.py -m card
--noconftest` there: `tests/conftest.py` loads JAX)."""

import time

import numpy as np
import pytest
import torch

from favae_tpu_torch import config as C
from favae_tpu_torch import graphs, profiling
from favae_tpu_torch.data import pipeline
from favae_tpu_torch.data.pipeline import DataLoader
from favae_tpu_torch.models.txt_cond import build_cat
from favae_tpu_torch.models.vqgan import build_model


def _cat_cfg():
    vq = C.VQGANConfig(
        codec=C.codec_for_downsample_factor(4, z_channels=8, base_channels=32,
                                            resolution=32),
        quantizer=C.QuantizerConfig(codebook_size=64, dim=8,
                                    use_cosine_sim=True),
        discriminator=C.DiscriminatorConfig(base_channels=32),
        fcm_kind="none", dsl_mode="none", compute_dtype="float32")
    gpt = C.GPTConfig(vocab_size=64, n_layer=2, n_embed=128, n_head=2,
                      dim_head=64, n_cond_embed=64, image_encoded_dim=4,
                      max_text_len=7, dropout=0.0)
    clip = C.CLIPTextConfig(context_length=7, vocab_size=100, width=64,
                            heads=2, layers=2, embed_dim=64)
    return C.CATConfig(vqgan=vq, clip=clip, gpt=gpt)


def _profiled(fn):
    """The `favae:` ranges that `fn()` opens, (name, start us, end us) in
    the order they start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("favae:")),
                  key=lambda r: r[1])


def test_span_without_a_profiler_is_one_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a: made.append(a))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: made.append(a))
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("data.wait") is profiling.span("codec.decode")
    with profiling.span("data.wait"):
        with profiling.span("codec.decode"):
            pass
    assert made == []


def test_span_under_a_profiler_is_a_nested_operator_range():
    def run():
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    got = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("favae:")}
    assert set(got) == {"favae:outer", "favae:inner"}
    outer, inner = got["favae:outer"], got["favae:inner"]
    assert outer.start_ns() <= inner.start_ns() <= inner.end_ns() \
        <= outer.end_ns()
    # no user annotation: the profiler draws no device-side copy of it
    assert not any(e.is_user_annotation() for e in got.values())


def test_codec_spans_in_order():
    model = build_model(_cat_cfg().vqgan, "cpu")
    x = torch.rand(1, 32, 32, 3) * 2 - 1
    # each stage's mid-block attention is a `codec.attn` inside it
    stages = ["favae:codec.encode", "favae:codec.attn",
              "favae:codec.quantize", "favae:codec.decode",
              "favae:codec.attn"]
    spans = _profiled(lambda: model.reconstruct(x))
    assert [n for n, _, _ in spans] == stages
    for outer, inner in ((0, 1), (3, 4)):
        assert spans[outer][1] <= spans[inner][1] <= spans[inner][2] \
            <= spans[outer][2]
    names = [n for n, _, _ in _profiled(
        lambda: model.generate(x, inference=True))]
    assert names == stages
    idx = torch.zeros(1, 8, 8, dtype=torch.long)
    assert [n for n, _, _ in _profiled(lambda: model.decode_code(idx))] == \
        ["favae:codec.decode", "favae:codec.attn"]


def test_sample_images_spans_in_order():
    cat = build_cat(_cat_cfg(), "cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 90, (1, 7)))
    noise = torch.from_numpy(np.random.RandomState(1).gumbel(
        size=(16, 1, 64)).astype(np.float32))
    spans = _profiled(lambda: cat.sample_images(ids, gumbel_noise=noise))
    names = [n for n, _, _ in spans]
    assert names == ["favae:cat.clip", "favae:cat.prepare",
                     "favae:cat.tokens", "favae:cat.decode",
                     "favae:codec.decode", "favae:codec.attn"]
    (_, a, b), (_, c, d), (_, e, f) = spans[3], spans[4], spans[5]
    assert a <= c <= e <= f <= d <= b  # the FA-VAE decode inside the stage


class SleepyDataset:
    """Items filled with their index after `sleep` seconds each
    (module-level: the process path pickles it)."""

    def __init__(self, n, sleep):
        self.n, self.sleep = n, sleep

    def __len__(self):
        return self.n

    def get(self, index):
        time.sleep(self.sleep)
        return np.full((2, 2, 3), index, np.float32)


def _count(loader, pause=0.0):
    """`pipeline.STATS`' rise over one epoch of `loader`, the consumer
    pausing `pause` s after each batch."""
    before = dict(pipeline.STATS)
    try:
        for _ in loader:
            time.sleep(pause)
    finally:
        loader.close()
    return {k: pipeline.STATS[k] - before[k] for k in before}


@pytest.mark.parametrize("use_processes", [False, True],
                         ids=["threads", "processes"])
def test_loader_counts_slow_and_fast_decodes(use_processes):
    slow = _count(DataLoader(SleepyDataset(12, 0.03), 2, num_workers=1,
                             use_processes=use_processes))
    assert slow["batches"] == 6
    assert slow["decode_s"] >= 0.9 * 6 * 2 * 0.03
    assert slow["ready"] < slow["batches"]
    assert slow["wait_s"] > 0
    fast = _count(DataLoader(SleepyDataset(16, 0.0), 2, num_workers=2,
                             use_processes=use_processes), pause=0.1)
    assert fast["batches"] == 8
    assert fast["ready"] >= fast["batches"] - 2  # the epoch's first is not
    assert fast["decode_s"] >= 0


def test_loader_wait_is_a_span():
    loader = DataLoader(SleepyDataset(4, 0.0), 2, num_workers=1)
    names = [n for n, _, _ in _profiled(lambda: list(loader))]
    assert names == ["favae:data.wait"] * 2


def test_counters_hold_every_group():
    from favae_tpu_torch.models import serving_plan
    from favae_tpu_torch.parallel import mesh
    got = profiling.counters()
    for launches in graphs.launch_counts():
        for k, v in launches.items():
            assert got[f"launches.{k}"] == v
    for group, stats in (*graphs.work_counts().items(),
                         ("collectives", mesh.STATS),
                         ("data", pipeline.STATS), ("graphs", graphs.STATS),
                         ("serving", serving_plan.STATS)):
        for k, v in stats.items():
            assert got[f"{group}.{k}"] == v
    assert {k.split(".")[0] for k in got} == {
        "launches", "vq", "decode_step", "rows_gemm", "ffn_int8", "codec",
        "collectives", "data", "graphs", "serving"}
    assert all(isinstance(v, (int, float)) for v in got.values())


def test_run_steps_counts_nothing_on_the_cpu():
    before = dict(graphs.STATS)
    graphs.run_steps(lambda: None, 4, "cpu")
    assert graphs.STATS == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: "
                    "python -m pytest tests/test_torch_port_tracing.py "
                    "-m card --noconftest)")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 2, 16])
def test_run_steps_counts_one_capture_and_n_minus_one_replays(card, n):
    x = torch.zeros((), device=card)
    before = dict(graphs.STATS)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        graphs.run_steps(lambda: x.add_(1), n, card)
        torch.cuda.synchronize()
    assert float(x) == n
    got = {k: graphs.STATS[k] - before[k] for k in before}
    assert got["captures"] == (n > 1) and got["replays"] == n - 1
    assert (got["capture_s"] > 0) == (n > 1)
    names = [e.name for e in prof.events() if e.name.startswith("favae:")]
    assert names.count("favae:graphs.first") == 1
    assert names.count("favae:graphs.capture") == (n > 1)
    assert names.count("favae:graphs.replay") == n - 1
