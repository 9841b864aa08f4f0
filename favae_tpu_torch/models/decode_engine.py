"""Serving-path CAT sampler: the routes of the token loop (port of
favae_tpu/models/decode_engine.py).

`sample_tokens` runs `models/gpt.py`'s `sample_loop`, the loop of
`GPT.sample`, over one of three routes of the same weights:

* exact (default): `gpt.EXACT` (`block_route`), `GPT.sample`'s own step;
  equal to `GPT.sample` token for token;
* `qparams` (`QPARAMS`, from `quantize_decode_params`): the same step with the
  feed-forward block of each layer through the fused int8 FFN kernel
  (`ops/ffn_int8.py`), one launch a layer a token;
* `fused` (`FUSED`, from `ops.decode_step_kernel.prepare_fused_decode`):
  every token's whole layer stack through one launch of the whole-step kernel,
  all large projections int8, the hidden state carried in f32, with its
  own init and final norms (`layer_norm_rows`).

The int8 routes are lossy opt-ins (`CATModel.sample_images(quantized=True)`);
the reference sampler has no quantized mode. A route casts only the weights
it uses; the GPT's serving plans keep the casts and the prepared weights
across requests (`models/serving_plan.py`). The fused route's kernel reads
the position from the loop's 0-dim tensor, as the TPU kernel reads its SMEM
scalar, and counts a position outside the cache in a device error word,
which `sample_tokens` reads once after the loop's last token.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from favae_tpu_torch.config import GPTConfig
from favae_tpu_torch.models.gpt import (EXACT, GPT, NEG_INF, Route,
                                       block_route, sample_loop)
from favae_tpu_torch.ops import decode_step_kernel, ffn_int8
from favae_tpu_torch.ops.ffn_int8 import layer_norm_rows, prepare_ffn_weights


def quantize_decode_params(gpt: GPT) -> Dict[str, Dict[str, torch.Tensor]]:
    """Quantise the feed-forward block of every layer for the fused int8 FFN
    kernel (about three quarters of a layer's weight bytes); the attention
    projections stay in `dtype`. Returns {"ffn": (L, ...)-stacked arrays of
    `prepare_ffn_weights`}."""
    preps = [prepare_ffn_weights(blk.ff[1].weight.detach().T,
                                 blk.ff[3].gamma.detach(),
                                 blk.ff[4].weight.detach().T)
             for blk in gpt.blocks]
    return {"ffn": {k: torch.stack([p[k] for p in preps]).contiguous()
                    for k in preps[0]}}


def _ffn_int8(gamma_in, prep, x):
    """A layer's feed-forward and residual add of x (rows, 1, dim)."""
    return ffn_int8.ffn_block_int8(x[:, 0], gamma_in, prep)[:, None]


def _attention(gpt: GPT):
    return [m for blk in gpt.blocks for m in (blk.self_attn, blk.cross_attn)]


def _qparams_route(gpt: GPT, context, mask, casts, prepared):
    """`block_route` with each layer's feed-forward through the int8 FFN
    kernel, from `quantize_decode_params`' stacks in `prepared`."""
    return block_route(gpt, context, mask, casts, ffns=[
        functools.partial(_ffn_int8, blk.ff[0].gamma,
                          {k: v[l] for k, v in prepared["ffn"].items()})
        for l, blk in enumerate(gpt.blocks)])


def _fused_route(gpt: GPT, context, mask, casts, prepared):
    """The whole-step kernel's route of `sample_loop`, from
    `prepare_fused_decode`'s set in `prepared`: the cross K/V with the
    null in slot 0 and the relative position bias tables stacked over the
    layers, the text mask as a bias; the position's bias rows gathered
    each step."""
    blocks, dtype, cfg = gpt.blocks, gpt.dtype, gpt.cfg
    dh, rows = cfg.dim_head, context.shape[0]

    def cross_now():
        ctx = context.to(dtype)
        kv = torch.stack([torch.cat(                      # (L, 2b, m+1, dh)
            [ca.null_kv.detach().to(dtype).expand(rows, 1, dh),
             ctx @ ca.to_kv[1].weight.detach().to(dtype).T], dim=1)
            for ca in (blk.cross_attn for blk in blocks)]).contiguous()
        bias = torch.where(F.pad(mask, (1, 0), value=True), 0.0,
                           NEG_INF).float()                    # (2b, m+1)
        return kv, bias

    cross_kv, cross_bias = cross_now()
    rel_idx = blocks[0].self_attn.rel_pos_bias.pos_indices    # (S, S)
    rel_table = torch.stack([blk.self_attn.rel_pos_bias.pos_bias.weight
                             for blk in blocks]).float()       # (L, n_rel, H)
    seq = cfg.image_encoded_dim ** 2
    caches = torch.zeros((cfg.n_layer, rows, seq, dh), dtype=dtype,
                         device=context.device)

    def step(x, pos):
        x = layer_norm_rows(x, gpt.init_norm.gamma).to(dtype)
        sel = rel_idx.index_select(0, pos.view(1))[0]
        rel = rel_table.index_select(1, sel)                   # (L, S, H)
        rel_rows = F.pad(rel.permute(0, 2, 1), (1, 0)).contiguous()
        x, _ = decode_step_kernel.decode_step_fused(
            x, pos, caches, cross_kv, cross_bias, rel_rows, prepared, cfg)
        return gpt._logits(layer_norm_rows(x, gpt.final_norm.gamma))

    def refill():
        kv, bias = cross_now()
        cross_kv.copy_(kv)
        cross_bias.copy_(bias)
        caches.zero_()

    return step, refill


QPARAMS = Route("qparams", _attention, _qparams_route)
FUSED = Route("fused", lambda gpt: [], _fused_route)


def sample_tokens(cfg: GPTConfig, gpt: GPT, text_embeds, text_mask, *,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: float = 1.0, cond_scale: float = 3.0,
                  qparams: Optional[dict] = None,
                  fused: Optional[dict] = None,
                  forced_tokens: Optional[torch.Tensor] = None,
                  return_logits: bool = False,
                  gumbel_noise: Optional[torch.Tensor] = None,
                  on_token: Optional[Callable[[int], None]] = None):
    """`sample_loop` over the route that `fused` or `qparams` picks (the
    exact one without either); `cfg`, the JAX function's argument, is the
    GPT's own configuration, which the routes read from the GPT. Returns
    the (b, grid, grid) int64 token grid, and with `return_logits` the CFG
    logits (`sample_loop`'s audit hooks). Prepared weights that the GPT's
    serving plans made (`serving_plan.weights`, as
    `CATModel.sample_images` gets them) run through a plan; a caller's own
    run without one. The fused route reads the kernel's error word after
    the last token."""
    route, prepared = ((FUSED, fused) if fused is not None
                       else (QPARAMS, qparams) if qparams is not None
                       else (EXACT, None))
    out = sample_loop(gpt, text_embeds, text_mask, route, prepared=prepared,
                      generator=generator, temperature=temperature,
                      top_k=top_k, top_p=top_p, cond_scale=cond_scale,
                      gumbel_noise=gumbel_noise, forced_tokens=forced_tokens,
                      return_logits=return_logits, on_token=on_token)
    if fused is not None:
        decode_step_kernel.check_positions(text_embeds.device)
    return out
