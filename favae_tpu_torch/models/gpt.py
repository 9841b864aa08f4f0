"""CAT, the cross-attention autoregressive transformer (port of
favae_tpu/models/gpt.py; reference: models/gpt_ca.py).

Decoder-only GPT over the FA-VAE token grid: axial 2-D positional embedding
and a learned start token; per layer causal self-attention, cross-attention
to the CLIP text tokens and a feed-forward, each with a residual; multi-head
queries over a single key/value head; a learned null key/value in slot 0
(classifier-free guidance); a 2-D relative position bias on self-attention;
a logits head tied to the token embedding; LayerNorm with a learned gamma
and no beta.

The parameters are named as the reference's state_dict (`blocks.{i}.{0,1,2}`,
`to_q.1.weight`, `to_out.2.gamma`, `blocks.{i}.2.{0,1,3,4}`,
`rel_pos_bias.pos_bias.weight`), so a reference checkpoint loads directly
(`convert.load_reference_gpt`). The JAX package scans one block over stacked
(L, ...) parameters; here the blocks are a `ModuleList`, and `sample`'s scan
over positions is a Python loop under `torch.inference_mode()` with per-layer
KV caches written in place.

Master weights are f32; projections run in `dtype` (bf16 by default) as the
JAX package's Dense layers do. `sample` casts each weight once, not once a
token. Ported for inference: the training-only parts (dropout on the q/kv
inputs, conditioning dropout with a random mask, `fold_ln_scale`) raise.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import GPTConfig

NEG_INF = -1e9  # large negative in place of -finfo.max (bf16-safe)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to favae_tpu_torch")


class FixedBetaLayerNorm(nn.Module):
    """LayerNorm with a learned gamma and a zero, non-learned beta, in f32
    (reference: models/gpt_ca.py:102-109). Returns f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.gamma.shape, self.gamma, None, 1e-5)


class Dense(nn.Linear):
    """Bias-free Linear computed in `compute_dtype` from an f32 master
    weight. `cast` holds the weight already cast while a sampler runs."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = compute_dtype
        self.cast: Optional[torch.Tensor] = None

    def forward(self, x):
        w = self.cast if self.cast is not None else self.weight.to(
            self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), w)


def _rel_pos_indices(size: int) -> np.ndarray:
    """(size^2, size^2) index table into the (2*size-1)^2 bias embedding
    (reference: models/gpt_ca.py:116-127)."""
    ar = np.arange(size)
    pos = np.stack(np.meshgrid(ar, ar, indexing="ij"), -1).reshape(-1, 2)
    rel = pos[:, None, :] - pos[None, :, :] + size - 1
    return rel[..., 0] * (2 * size - 1) + rel[..., 1]


class RelPosBias2d(nn.Module):
    """2-D relative position bias (reference: models/gpt_ca.py:113-136)."""

    def __init__(self, size: int, heads: int):
        super().__init__()
        self.pos_bias = nn.Embedding((2 * size - 1) ** 2, heads)
        self.register_buffer(
            "pos_indices", torch.from_numpy(_rel_pos_indices(size)).long(),
            persistent=False)

    def forward(self, i: int, j: int, row_offset: Optional[int] = None):
        """Bias (heads, i, j) for a sim of shape (..., i, j); key slot 0 is
        the null kv and gets zero bias. With `row_offset` (incremental
        decoding, i == 1) the single query row is the one at that position."""
        rows = (self.pos_indices[:i] if row_offset is None
                else self.pos_indices[row_offset:row_offset + 1])
        bias = self.pos_bias(rows[:, : j - 1])          # (i, j-1, heads)
        return F.pad(bias.permute(2, 0, 1), (1, 0))


class MultiQueryAttention(nn.Module):
    """Multi-head queries over one key/value head, with a learned null kv
    (reference: models/gpt_ca.py:152-248)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 causal: bool = False, rel_pos_size: Optional[int] = None,
                 context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.dtype = dtype
        inner = heads * dim_head
        self.norm = FixedBetaLayerNorm(dim)
        # index 0 is the reference's Dropout (to_q, to_kv) or Rearrange
        # (to_out); the Linear sits at index 1
        self.to_q = nn.Sequential(nn.Identity(), Dense(dim, inner, dtype))
        self.to_kv = nn.Sequential(
            nn.Identity(), Dense(context_dim or dim, dim_head, dtype))
        self.null_kv = nn.Parameter(torch.randn(dim_head))
        self.to_out = nn.Sequential(nn.Identity(), Dense(inner, dim, dtype),
                                    FixedBetaLayerNorm(dim))
        if rel_pos_size is not None:
            self.rel_pos_bias = RelPosBias2d(rel_pos_size, heads)
        else:
            self.rel_pos_bias = None

    def _attend(self, q, kv, *, context_mask=None, causal_offset=None,
                rel_bias=None):
        """q (b, n, h, d); kv (b, m, d) without the null; (b, n, h*d)."""
        b = q.shape[0]
        null = self.null_kv.to(kv.dtype).expand(b, 1, self.dim_head)
        kv_full = torch.cat([null, kv], dim=1)           # (b, m+1, d)
        sim = torch.einsum("bnhd,bmd->bhnm", q, kv_full).float()
        if rel_bias is not None:
            sim = sim + rel_bias
        if context_mask is not None:
            cm = F.pad(context_mask, (1, 0), value=True)
            sim = torch.where(cm[:, None, None, :], sim, NEG_INF)
        if causal_offset is not None:
            n, m = sim.shape[-2:]
            rows = torch.arange(n, device=sim.device)[:, None] + causal_offset
            cols = torch.arange(m, device=sim.device)[None, :]  # 0 = null kv
            sim = torch.where((cols <= rows + 1)[None, None], sim, NEG_INF)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhnm,bmd->bnhd", attn.to(kv_full.dtype), kv_full)
        return out.reshape(b, q.shape[1], self.heads * self.dim_head)

    def _q(self, x_n):
        q = self.to_q(x_n) * (self.dim_head ** -0.5)
        return q.reshape(q.shape[0], q.shape[1], self.heads, self.dim_head)

    def forward(self, x, *, context=None, context_mask=None):
        x_n = self.norm(x).to(self.dtype)
        q = self._q(x_n)
        kv = self.to_kv(x_n if context is None else context)
        rel_bias = None
        if self.rel_pos_bias is not None:
            rel_bias = self.rel_pos_bias(q.shape[1], kv.shape[1] + 1)[None]
        out = self._attend(q, kv, context_mask=context_mask,
                           causal_offset=0 if self.causal else None,
                           rel_bias=rel_bias)
        return self.to_out(out).to(x.dtype)

    # ---- incremental decoding -------------------------------------------
    def project_kv(self, context):
        """kv of a static context (the cross-attention cache)."""
        return self.to_kv(context)

    def decode_step(self, x_t, kv_cache, pos: int):
        """One causal self-attention step. x_t (b, 1, dim); kv_cache
        (b, S, dim_head), whose row `pos` is written in place and whose
        rows beyond it are masked. Returns the attention output."""
        x_n = self.norm(x_t).to(self.dtype)
        q = self._q(x_n)
        kv_cache[:, pos] = self.to_kv(x_n)[:, 0].to(kv_cache.dtype)
        rel_bias = None
        if self.rel_pos_bias is not None:
            rel_bias = self.rel_pos_bias(1, kv_cache.shape[1] + 1,
                                         row_offset=pos)[None]
        mask = (torch.arange(kv_cache.shape[1], device=x_t.device)
                <= pos).expand(x_t.shape[0], -1)
        out = self._attend(q, kv_cache, context_mask=mask, rel_bias=rel_bias)
        return self.to_out(out).to(x_t.dtype)

    def cross_step(self, x_t, kv, context_mask):
        """One cross-attention step against precomputed kv."""
        x_n = self.norm(x_t).to(self.dtype)
        out = self._attend(self._q(x_n), kv, context_mask=context_mask)
        return self.to_out(out).to(x_t.dtype)


class FeedForward(nn.Sequential):
    """LN -> Dense 4x -> GELU (erf) -> LN -> Dense, indexed as the
    reference's Sequential (models/gpt_ca.py:140-148)."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(FixedBetaLayerNorm(dim), Dense(dim, dim * mult, dtype),
                         nn.GELU(), FixedBetaLayerNorm(dim * mult),
                         Dense(dim * mult, dim, dtype))
        self.dtype = dtype

    def forward(self, x):
        h = self[1](self[0](x).to(self.dtype))
        h = self[4](self[3](self[2](h)).to(self.dtype))
        return h.to(x.dtype)


class CATBlock(nn.ModuleList):
    """One layer: [causal self-attention, cross-attention, feed-forward]
    (reference: gpt_ca.py:268-274,320-323)."""

    def __init__(self, cfg: GPTConfig, dtype: torch.dtype):
        c = cfg
        super().__init__([
            MultiQueryAttention(c.n_embed, c.n_head, c.dim_head, causal=True,
                                rel_pos_size=c.image_encoded_dim, dtype=dtype),
            MultiQueryAttention(c.n_embed, c.n_head, c.dim_head, causal=False,
                                context_dim=c.n_cond_embed, dtype=dtype),
            FeedForward(c.n_embed, dtype=dtype)])

    @property
    def self_attn(self) -> MultiQueryAttention:
        return self[0]

    @property
    def cross_attn(self) -> MultiQueryAttention:
        return self[1]

    @property
    def ff(self) -> FeedForward:
        return self[2]

    def forward(self, x, context, context_mask):
        x = self.self_attn(x) + x
        x = self.cross_attn(x, context=context, context_mask=context_mask) + x
        return self.ff(x) + x

    def decode(self, x, cache, cross_kv, context_mask, pos: int):
        """Incremental step: x (b, 1, dim); cache (b, S, dh), written in
        place at `pos`; cross_kv (b, m, dh)."""
        x = self.self_attn.decode_step(x, cache, pos) + x
        x = self.cross_attn.cross_step(x, cross_kv, context_mask) + x
        return self.ff(x) + x


class GPT(nn.Module):
    """reference: models/gpt_ca.py:250-393."""

    def __init__(self, cfg: GPTConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.fold_ln_scale:
            raise _not_ported("fold_ln_scale (a training reparameterisation)")
        self.cfg, self.dtype = cfg, dtype
        c = cfg
        self.tok_emb = nn.Embedding(c.vocab_size, c.n_embed)
        nn.init.normal_(self.tok_emb.weight, std=0.02)
        self.axial_height_pos = nn.Parameter(
            torch.randn(c.image_encoded_dim, c.n_embed))
        self.axial_width_pos = nn.Parameter(
            torch.randn(c.image_encoded_dim, c.n_embed))
        self.start_token = nn.Parameter(torch.randn(c.n_embed))
        self.init_norm = FixedBetaLayerNorm(c.n_embed)
        self.final_norm = FixedBetaLayerNorm(c.n_embed)
        self.blocks = nn.ModuleList(
            CATBlock(c, dtype) for _ in range(c.n_layer))

    # ------------------------------------------------------------------
    def _axial_pos(self):
        pos = (self.axial_width_pos[None, :, :]
               + self.axial_height_pos[:, None, :])
        return pos.reshape(-1, self.cfg.n_embed)

    def _embed_tokens(self, image_token_ids):
        """[start] + tok_emb(ids) + axial pos (reference: gpt_ca.py:287-301)."""
        b, n = image_token_ids.shape
        emb = self.tok_emb(image_token_ids) + self._axial_pos()[:n][None]
        start = self.start_token.expand(b, 1, -1)
        return torch.cat([start, emb], dim=1)

    def _logits(self, x):
        # weight tying (gpt_ca.py:278-279)
        return x.float() @ self.tok_emb.weight.float().T

    @contextlib.contextmanager
    def cast_weights(self):
        """While inside, every Dense uses a weight cast once to its compute
        dtype instead of casting on each call."""
        dense = [m for m in self.modules() if isinstance(m, Dense)]
        try:
            for m in dense:
                m.cast = m.weight.detach().to(m.compute_dtype)
            yield
        finally:
            for m in dense:
                m.cast = None

    def forward(self, image_token_ids, text_token_embeds, text_mask, *,
                cond_drop_prob: Optional[float] = None, train: bool = False):
        """Teacher-forced forward -> logits (b, n+1, vocab) (reference:
        gpt_ca.py:284-331). Eval mode only: `cond_drop_prob` must be 0 (keep
        the text) or >= 1 (drop it for every row)."""
        c = self.cfg
        if train:
            raise _not_ported("the GPT training forward (dropout, remat)")
        cond_drop_prob = (c.cond_drop_prob if cond_drop_prob is None
                          else cond_drop_prob)
        x = self._embed_tokens(image_token_ids)
        text_token_embeds = text_token_embeds[:, : c.max_text_len]
        text_mask = text_mask[:, : c.max_text_len]
        if cond_drop_prob >= 1:
            text_mask = torch.zeros_like(text_mask)
        elif cond_drop_prob > 0:
            raise _not_ported("conditioning dropout with a random mask "
                              "(0 < cond_drop_prob < 1)")
        # the reference defines a cond_proj Linear but never calls it
        # (gpt_ca.py:259 vs :322): context enters to_kv raw
        x = self.init_norm(x).to(self.dtype)
        context = text_token_embeds.float()
        for block in self.blocks:
            x = block(x, context, text_mask)
        return self._logits(self.final_norm(x))

    def forward_with_cond_scale(self, image_token_ids, text_token_embeds,
                                text_mask, cond_scale: float = 3.0):
        """CFG-combined logits (reference: gpt_ca.py:334-341)."""
        logits = self(image_token_ids, text_token_embeds, text_mask,
                      cond_drop_prob=0.0)
        if cond_scale == 1:
            return logits
        null_logits = self(image_token_ids, text_token_embeds,
                           torch.zeros_like(text_mask), cond_drop_prob=0.0)
        return null_logits + (logits - null_logits) * cond_scale

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def sample(self, text_token_embeds, text_mask, *,
               generator: Optional[torch.Generator] = None,
               temperature: float = 1.0, top_k: Optional[int] = None,
               top_p: float = 1.0, cond_scale: float = 3.0,
               gumbel_noise: Optional[torch.Tensor] = None,
               on_token: Optional[Callable[[int], None]] = None):
        """Autoregressive sampling with KV caches (functionally the
        reference's gpt_ca.py:343-367, which re-forwards the prefix for every
        token). CFG runs as a 2B batch: rows [0:B] conditional, [B:2B] with
        an all-false text mask. `gumbel_noise` (S, B, vocab) replaces the
        generator's draws; `on_token(pos)` is called after each token's work is
        queued. Returns the (B, grid, grid) int64 token grid."""
        c = self.cfg
        b = text_token_embeds.shape[0]
        seq_len = c.image_encoded_dim ** 2
        dev = text_token_embeds.device

        text_token_embeds = text_token_embeds[:, : c.max_text_len]
        text_mask = text_mask[:, : c.max_text_len]
        ctx2 = torch.cat([text_token_embeds, text_token_embeds], 0).float()
        mask2 = torch.cat([text_mask, torch.zeros_like(text_mask)], 0)

        with self.cast_weights():
            cross_kv = [blk.cross_attn.project_kv(ctx2) for blk in self.blocks]
            caches = torch.zeros((c.n_layer, 2 * b, seq_len, c.dim_head),
                                 dtype=self.dtype, device=dev)
            axial = self._axial_pos()
            start = self.start_token.expand(2 * b, -1)
            tok_prev = torch.zeros((2 * b,), dtype=torch.long, device=dev)
            tokens = []
            for pos in range(seq_len):
                x = start if pos == 0 else self.tok_emb(tok_prev) + axial[pos - 1]
                x = self.init_norm(x)[:, None, :].to(self.dtype)
                for l, blk in enumerate(self.blocks):
                    x = blk.decode(x, caches[l], cross_kv[l], mask2, pos)
                logits2 = self._logits(self.final_norm(x[:, 0, :]))
                cond, null = logits2[:b], logits2[b:]
                logits = (cond if cond_scale == 1
                          else null + (cond - null) * cond_scale)
                logits = top_k_top_p_filter(logits, top_k, top_p)
                tok = gumbel_sample(
                    logits, generator, temperature,
                    None if gumbel_noise is None else gumbel_noise[pos])
                tok_prev = torch.cat([tok, tok], 0)
                tokens.append(tok)
                if on_token is not None:
                    on_token(pos)
        g = c.image_encoded_dim
        return torch.stack(tokens, dim=1).reshape(b, g, g)


def gumbel_sample(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0,
                  noise: Optional[torch.Tensor] = None):
    """(logits / T + gumbel).argmax (reference: gpt_ca.py:35-40). `noise`
    replaces the generator's gumbel draw."""
    if noise is None:
        dev = logits.device if generator is None else generator.device
        u = torch.rand(logits.shape, generator=generator, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        noise = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() / temperature + noise.to(logits.device),
                        dim=-1)


def top_k_top_p_filter(logits, top_k: Optional[int] = None,
                       top_p: float = 1.0):
    """reference: gpt_ca.py:370-393. logits (..., vocab). The sort is
    stable, so entries tied at NEG_INF after top-k keep their index order."""
    if top_k is not None:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # shift right: always keep the first token above the threshold
        mask = F.pad(cum > top_p, (1, 0))[..., :-1]
        mask = torch.zeros_like(mask).scatter(-1, sort_idx, mask)
        logits = torch.where(mask, NEG_INF, logits)
    return logits
