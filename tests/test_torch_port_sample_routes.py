"""The one token loop of the CAT samplers (`models/gpt.py`'s `sample_loop`)
over each route of `models/decode_engine.py`'s `sample_tokens`, on the CPU:
the kernel wrappers a route's token step calls, counted over a sample as
tests/test_torch_port_mqa_decode.py counts them, and the Dense weights each
route has cast while it runs. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from favae_tpu_torch import config as tcfg
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                  sample_tokens)
from favae_tpu_torch.ops import (decode_step_kernel, ffn_int8, ln_fused,
                                 mqa_decode)
from favae_tpu_torch.ops.decode_step_kernel import prepare_fused_decode

# a width every route takes (tests/test_torch_port_decode.py's GATE)
GATE = dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2, dim_head=64,
            n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
            dropout=0.0)
WRAPPERS = ((mqa_decode, "self_attend"), (mqa_decode, "cross_attend"),
            (ln_fused, "add_ln"), (ln_fused, "gelu_ln"),
            (ffn_int8, "ffn_block_int8"),
            (decode_step_kernel, "decode_step_fused"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return tgpt.GPT(tcfg.GPTConfig(**GATE), dtype=torch.bfloat16).eval()


def _cast(gpt):
    return {name for name, m in gpt.named_modules()
            if isinstance(m, tgpt.Dense) and m.cast is not None}


def _count_calls(monkeypatch, gpt):
    """Count each wrapper's calls; gather the names of the Dense weights
    that are cast whenever one is called."""
    calls, cast = dict.fromkeys((name for _, name in WRAPPERS), 0), set()
    for mod, name in WRAPPERS:
        def counted(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            cast.update(_cast(gpt))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls, cast


@pytest.mark.parametrize("route", ["exact", "qparams", "fused"])
def test_each_route_calls_its_wrappers(monkeypatch, route):
    """B 4 (8 CFG rows), 16 tokens, 2 layers: the exact and `qparams`
    routes run `CATBlock.decode` (an attention call of each form a layer a
    token, a boundary into the first layer and three a layer), the first
    with the blocks' feed-forwards (`gelu_ln`), the second with the int8
    block and only the attention weights cast; the fused route one
    whole-step call a token and no Dense weight cast."""
    gpt = _gpt()
    rng = np.random.RandomState(1)
    te = torch.from_numpy(rng.randn(4, 7, 32).astype(np.float32))
    tm = torch.from_numpy(rng.rand(4, 7) > 0.2)
    noise = torch.from_numpy(rng.gumbel(size=(16, 4, 64)).astype(np.float32))
    kw = {"exact": {},
          "qparams": {"qparams": quantize_decode_params(gpt)},
          "fused": {"fused": prepare_fused_decode(gpt, gpt.cfg)}}[route]
    calls, cast = _count_calls(monkeypatch, gpt)
    grid = sample_tokens(gpt.cfg, gpt, te, tm, gumbel_noise=noise, top_k=8,
                         **kw)
    assert grid.shape == (4, 4, 4)
    seq, L = 16, GATE["n_layer"]
    blocks = {"self_attend": seq * L, "cross_attend": seq * L,
              "add_ln": seq * (1 + 3 * L)}
    want = {"exact": dict(blocks, gelu_ln=seq * L),
            "qparams": dict(blocks, ffn_block_int8=seq * L),
            "fused": dict(decode_step_fused=seq)}[route]
    assert calls == {name: want.get(name, 0) for name in calls}
    attention = {f"blocks.{l}.{a}.{p}.1" for l in range(L) for a in (0, 1)
                 for p in ("to_q", "to_kv", "to_out")}
    ffn = {f"blocks.{l}.2.{i}" for l in range(L) for i in (1, 4)}
    assert cast == {"exact": attention | ffn, "qparams": attention,
                    "fused": set()}[route]
    assert not _cast(gpt)
