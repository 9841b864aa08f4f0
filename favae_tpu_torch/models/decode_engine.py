"""Serving-path CAT sampler: the token loop written out over the GPT's
layers (port of favae_tpu/models/decode_engine.py).

`GPT.sample` (models/gpt.py) is the reference-faithful KV-cache sampler;
`sample_tokens` is the serving engine over the same weights, with three
routes:

* exact (default): every projection in `dtype`, the hidden state carried in
  `dtype` between layers; equal to `GPT.sample` token for token;
* `qparams` (from `quantize_decode_params`): the feed-forward block of each
  layer through the fused int8 FFN kernel (`ops/ffn_int8.py`), one launch a
  layer a token; attention as in the exact route;
* `fused` (from `ops.decode_step_kernel.prepare_fused_decode`): every
  token's whole layer stack through one launch of the whole-step kernel,
  all large projections int8, the hidden state carried in f32.

The int8 routes are lossy opt-ins (`CATModel.sample_images(quantized=True)`);
the reference sampler has no quantized mode. Each weight is cast to `dtype`
once before the loop. A token step keeps its state in tensors it updates in
place (the cache position among them, as a 0-dim tensor) and makes no host
sync, so on the card every route runs it as a CUDA graph, the counterpart of
the JAX engine's `lax.scan` over positions (`graphs.run_steps`: the first
token eagerly, then one capture of the step replayed for the others); on the
CPU the same step runs eagerly. The fused route's kernel reads the position
from that tensor, as the TPU kernel reads its SMEM scalar, and counts a
position outside the cache in a device error word, which the route reads
once after its last token.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from favae_tpu_torch.config import GPTConfig
from favae_tpu_torch.graphs import run_steps
from favae_tpu_torch.models.gpt import (GPT, NEG_INF, gumbel_sample,
                                        top_k_top_p_filter)
from favae_tpu_torch.ops.decode_step_kernel import (check_positions,
                                                    decode_step_fused)
from favae_tpu_torch.ops.ffn_int8 import (ffn_block_int8, layer_norm_rows,
                                          prepare_ffn_weights)


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


def _attend(q, kv_full, bias, heads: int, dim_head: int):
    """q (b, h*dh) against kv_full (b, m, dh) with the null kv already in
    slot 0; `bias` (f32, broadcastable to (b, h, m)) is added to the sim."""
    b = q.shape[0]
    q = q.reshape(b, heads, dim_head)
    sim = torch.einsum("bhd,bmd->bhm", q, kv_full).float() + bias
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhm,bmd->bhd", attn.to(kv_full.dtype), kv_full)
    return out.reshape(b, heads * dim_head)


@torch.inference_mode()
def sample_tokens(cfg: GPTConfig, gpt: GPT, text_embeds, text_mask, *,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: float = 1.0, cond_scale: float = 3.0,
                  qparams: Optional[dict] = None,
                  fused: Optional[dict] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  forced_tokens: Optional[torch.Tensor] = None,
                  return_logits: bool = False,
                  gumbel_noise: Optional[torch.Tensor] = None,
                  on_token: Optional[Callable[[int], None]] = None):
    """CFG sampling loop equal to `GPT.sample`, the layer loop written out.
    Returns the (b, grid, grid) int64 token grid.

    Audit hooks: `forced_tokens` (b, S) teacher-forces the autoregressive
    context, so that two engines see the same prefixes and their logits can
    be compared; `return_logits=True` also returns the CFG-combined logits
    (b, S, vocab) before top-k/top-p. `gumbel_noise` (S, b, vocab) replaces
    the generator's draws; `on_token(pos)` is called after each token's work
    is queued."""
    c = cfg
    b = text_embeds.shape[0]
    dev = text_embeds.device
    seq_len = c.image_encoded_dim ** 2
    heads, dh = c.n_head, c.dim_head
    scale = dh ** -0.5
    blocks = gpt.blocks

    def w(dense):  # (in, out) in dtype, cast once
        return dense.weight.detach().to(dtype).T

    text_embeds = text_embeds[:, : c.max_text_len].float()
    text_mask = text_mask[:, : c.max_text_len]
    ctx2 = torch.cat([text_embeds, text_embeds], 0).to(dtype)
    mask2 = torch.cat([text_mask, torch.zeros_like(text_mask)], 0)

    # per-layer cross-attention kv (computed once) with the null in slot 0
    cross_kv = []
    for blk in blocks:
        ca = blk.cross_attn
        null = ca.null_kv.detach().to(dtype).expand(2 * b, 1, dh)
        cross_kv.append(torch.cat([null, ctx2 @ w(ca.to_kv[1])], dim=1))
    # cross mask bias (the same at every step): the null slot always visible
    cm = F.pad(mask2, (1, 0), value=True)
    cross_bias = torch.where(cm, 0.0, NEG_INF).float()        # (2b, m+1)

    rel_idx = blocks[0].self_attn.rel_pos_bias.pos_indices    # (S, S)
    axial = gpt._axial_pos()
    start = gpt.start_token.expand(2 * b, -1)
    emb = gpt.tok_emb.weight
    caches = torch.zeros((c.n_layer, 2 * b, seq_len, dh), dtype=dtype,
                         device=dev)

    def embed_step(tok_prev, pos):
        prev = emb[tok_prev] + axial.index_select(0, (pos - 1).clamp(min=0)
                                                  .view(1))
        x = torch.where(pos == 0, start, prev)
        return layer_norm_rows(x, gpt.init_norm.gamma).to(dtype)

    def cfg_logits(logits2):
        cond, null = logits2[:b], logits2[b:]
        return cond if cond_scale == 1 else null + (cond - null) * cond_scale

    def head(x):
        x = layer_norm_rows(x, gpt.final_norm.gamma)
        return x @ emb.float().T                               # weight tying

    if fused is not None:
        cross_kv_st = torch.stack(cross_kv).contiguous()       # (L, 2b, m+1, dh)
        rel_table = torch.stack([blk.self_attn.rel_pos_bias.pos_bias.weight
                                 for blk in blocks]).float()   # (L, n_rel, H)

        def step_logits(tok_prev, pos):
            x = embed_step(tok_prev, pos)
            sel = rel_idx.index_select(0, pos.view(1))[0]
            rel = rel_table.index_select(1, sel)               # (L, S, H)
            rel_rows = F.pad(rel.permute(0, 2, 1), (1, 0)).contiguous()
            x, _ = decode_step_fused(x, pos, caches, cross_kv_st, cross_bias,
                                     rel_rows, fused, c)
            return head(x)
    else:
        wts = [dict(sq=w(blk.self_attn.to_q[1]), skv=w(blk.self_attn.to_kv[1]),
                    so=w(blk.self_attn.to_out[1]),
                    cq=w(blk.cross_attn.to_q[1]), co=w(blk.cross_attn.to_out[1]),
                    fc1=None if qparams is not None else w(blk.ff[1]),
                    fc2=None if qparams is not None else w(blk.ff[4]),
                    null=blk.self_attn.null_kv.detach().to(dtype).expand(
                        2 * b, 1, dh))
               for blk in blocks]
        cols = torch.arange(seq_len, device=dev)
        preps = None if qparams is None else [
            {k: v[l] for k, v in qparams["ffn"].items()}
            for l in range(c.n_layer)]

        def step_logits(tok_prev, pos):
            x = embed_step(tok_prev, pos)
            # self-attention mask bias (cols <= pos; col 0 the null, visible)
            self_bias = F.pad(torch.where(cols <= pos, 0.0, NEG_INF), (1, 0))
            sel = rel_idx.index_select(0, pos.view(1))[0]
            for l, (blk, wt) in enumerate(zip(blocks, wts)):
                sa, ca, ff = blk.self_attn, blk.cross_attn, blk.ff
                # --- causal self-attention over the KV cache ---
                x_n = layer_norm_rows(x, sa.norm.gamma).to(dtype)
                q = (x_n @ wt["sq"]) * scale
                caches[l].index_copy_(1, pos.view(1),
                                      (x_n @ wt["skv"])[:, None])
                kv_full = torch.cat([wt["null"], caches[l]], dim=1)
                rb = F.pad(sa.rel_pos_bias.pos_bias.weight[sel].T, (1, 0))
                h = _attend(q, kv_full, (self_bias + rb)[None], heads, dh)
                h = layer_norm_rows(h @ wt["so"], sa.to_out[2].gamma)
                x = h.to(x.dtype) + x

                # --- cross-attention to the text tokens ---
                x_n = layer_norm_rows(x, ca.norm.gamma).to(dtype)
                q = (x_n @ wt["cq"]) * scale
                h = _attend(q, cross_kv[l], cross_bias[:, None, :], heads, dh)
                h = layer_norm_rows(h @ wt["co"], ca.to_out[2].gamma)
                x = h.to(x.dtype) + x

                # --- feed-forward ---
                if qparams is not None:
                    x = ffn_block_int8(x, ff[0].gamma, preps[l])
                else:
                    h = layer_norm_rows(x, ff[0].gamma).to(dtype) @ wt["fc1"]
                    h = F.gelu(h)
                    h = layer_norm_rows(h, ff[3].gamma).to(dtype) @ wt["fc2"]
                    x = h.to(x.dtype) + x
            return head(x)

    # the step's state lives in tensors that it updates in place, the
    # position among them, so that one capture of it serves every position
    state = dict(pos=torch.zeros((), dtype=torch.long, device=dev),
                 tok_prev=torch.zeros((2 * b,), dtype=torch.long, device=dev),
                 tokens=torch.zeros((b, seq_len), dtype=torch.long,
                                    device=dev))
    if return_logits:
        state["logits"] = torch.zeros((b, seq_len, emb.shape[0]),
                                      dtype=torch.float32, device=dev)
    noise_all = None if gumbel_noise is None else gumbel_noise.to(dev)
    forced_all = None if forced_tokens is None else forced_tokens.to(dev).long()

    def token_step():
        pos = state["pos"]
        at = pos.view(1)
        logits = cfg_logits(step_logits(state["tok_prev"], pos))
        tok = gumbel_sample(top_k_top_p_filter(logits, top_k, top_p),
                            generator, temperature,
                            None if noise_all is None
                            else noise_all.index_select(0, at)[0])
        # teacher-force the carried context after recording the free sample
        carry = (tok if forced_all is None
                 else forced_all.index_select(1, at)[:, 0])
        state["tok_prev"].copy_(torch.cat([carry, carry], 0))
        state["tokens"].index_copy_(1, at, tok[:, None])
        if return_logits:
            state["logits"].index_copy_(1, at, logits[:, None].float())
        pos.add_(1)

    run_steps(token_step, seq_len, dev,
              generator=generator if gumbel_noise is None else None,
              after=on_token)
    if fused is not None:
        check_positions(dev)
    g = c.image_encoded_dim
    grid = state["tokens"].reshape(b, g, g)
    if return_logits:
        return grid, state["logits"]
    return grid
