"""Frozen copy of the port's `models/gpt.py` cut to what the benchmark runs,
the benchmark's reference (imports nothing of the port; see ../README.md):
the teacher-forced forward, in training and with CFG. The incremental
sampler and tensor parallelism are not carried: the benchmark judges served
tokens by the full forward.

CAT, the cross-attention autoregressive transformer (port of
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
`rel_pos_bias.pos_bias.weight`), so a reference checkpoint loads directly.

Master weights are f32; projections run in `dtype` (bf16 by default) as the
JAX package's Dense layers do.

Training (`forward(..., train=True)`, favae_tpu/models/gpt.py:203-529):
dropout on the inputs of `to_q` and `to_kv` (separate masks; the FFN has
none, as in the reference), conditioning dropout that drops a row's text
with probability `cond_drop_prob`, `fold_ln_scale` (each pre-projection
LayerNorm's gamma folded into the next projection's weight) and `remat`.
Every random draw comes from the caller's `torch.Generator`, never from the
global RNG: a block's masks are drawn before the block runs, so a block
recomputed under activation checkpointing sees the same masks.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from benchmark.reference.config import GPTConfig
from benchmark.reference.precision import fake_fp8

NEG_INF = -1e9  # large negative in place of -finfo.max (bf16-safe)

# activation checkpointing of the blocks on the training path, as the JAX
# package's `_scan_blocks` (favae_tpu/models/gpt.py:405-432): the products
# whose outputs a selective policy saves (JAX's checkpoint_dots and
# checkpoint_dots_with_no_batch_dims); everything else is recomputed
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_nb": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
}
REMAT_POLICIES = ("none", "full", "dots", "dots_nb")


def _save_products(saved, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dropout(x, keep: Optional[torch.Tensor], keep_prob: float):
    """flax `nn.Dropout` with the mask given: kept entries scaled by
    1/keep_prob in x's dtype, dropped ones zero."""
    if keep is None:
        return x
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class FixedBetaLayerNorm(nn.Module):
    """LayerNorm with a learned gamma and a zero, non-learned beta, in f32
    (reference: models/gpt_ca.py:102-109). Returns f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.gamma.shape, self.gamma, None, 1e-5)

    def parts(self, x):
        """(x normalised without gamma, f32; gamma), for a caller that folds
        gamma into the next projection (favae_tpu/models/gpt.py:54-80)."""
        return F.layer_norm(x.float(), self.gamma.shape, None, None,
                            1e-5), self.gamma


class Dense(nn.Linear):
    """Bias-free Linear computed in `compute_dtype` from an f32 master
    weight. `scale`, a
    per-input-feature vector, is folded into the f32 weight first
    (`W * scale[None, :]` in the (out, in) layout; favae_tpu's ScaledDense,
    gpt.py:83-99)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = compute_dtype
        self.fp8 = False

    def forward(self, x, scale: Optional[torch.Tensor] = None):
        if self.fp8:
            w = self.weight if scale is None else self.weight * scale[None, :]
            return fake_fp8(F.linear(fake_fp8(x).to(self.compute_dtype),
                                     fake_fp8(w).to(self.compute_dtype)))
        if scale is not None:
            w = (self.weight * scale[None, :]).to(self.compute_dtype)
        else:
            w = self.weight.to(self.compute_dtype)
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

    def forward(self, i: int, j: int):
        """Bias (heads, i, j) for a sim of shape (..., i, j); key slot 0 is
        the null kv and gets zero bias."""
        rows = self.pos_indices[:i]
        bias = F.embedding(rows[:, : j - 1], self.pos_bias.weight)
        return F.pad(bias.permute(2, 0, 1), (1, 0))  # (heads, i, j)


class MultiQueryAttention(nn.Module):
    """Multi-head queries over one key/value head, with a learned null kv
    (reference: models/gpt_ca.py:152-248)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 causal: bool = False, rel_pos_size: Optional[int] = None,
                 context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.0, fold_ln_scale: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.dtype, self.dropout, self.fold = dtype, dropout, fold_ln_scale
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

    def _rel_bias(self, i: int, j: int):
        if self.rel_pos_bias is None:
            return None
        return self.rel_pos_bias(i, j)[None]

    def _out(self, out, dtype):
        """to_out: the projection, then its LayerNorm."""
        return self.to_out[2](self.to_out[1](out)).to(dtype)

    def _attend(self, q, kv, *, context_mask=None, causal_offset=None,
                rel_bias=None):
        """q (b, n, h, d); kv (b, m, d) without the null; (b, n, h*d)."""
        b, heads = q.shape[0], q.shape[2]
        null = self.null_kv.to(kv.dtype).expand(b, 1, self.dim_head)
        kv_full = torch.cat([null, kv], dim=1)
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
        return out.reshape(b, q.shape[1], heads * self.dim_head)

    def forward(self, x, *, context=None, context_mask=None,
                keep_q: Optional[torch.Tensor] = None,
                keep_kv: Optional[torch.Tensor] = None):
        """`keep_q`, `keep_kv`: dropout keep masks of the inputs of to_q (the
        normed x) and of to_kv (the normed x, or the context), or None
        (favae_tpu/models/gpt.py:262-299). With `fold_ln_scale` the norm's
        gamma goes into to_q's weight (and to_kv's in self-attention), and
        the dropped inputs are f32, as in the JAX package."""
        p = 1.0 - self.dropout
        if self.fold:
            x_n, g = self.norm.parts(x)
            q_scale, kv_scale = g, (g if context is None else None)
            ctx = x_n if context is None else context.float()
        else:
            x_n = self.norm(x).to(self.dtype)
            q_scale = kv_scale = None
            ctx = x_n if context is None else context.to(self.dtype)
        q = self.to_q[1](_dropout(x_n, keep_q, p), q_scale) \
            * (self.dim_head ** -0.5)
        q = q.reshape(q.shape[0], q.shape[1], self.heads, self.dim_head)
        kv = self.to_kv[1](_dropout(ctx, keep_kv, p), kv_scale)
        out = self._attend(q, kv, context_mask=context_mask,
                           causal_offset=0 if self.causal else None,
                           rel_bias=self._rel_bias(q.shape[1],
                                                   kv.shape[1] + 1))
        return self._out(out, x.dtype)

class FeedForward(nn.Sequential):
    """LN -> Dense 4x -> GELU (erf) -> LN -> Dense, indexed as the
    reference's Sequential (models/gpt_ca.py:140-148)."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 fold_ln_scale: bool = False):
        super().__init__(FixedBetaLayerNorm(dim), Dense(dim, dim * mult, dtype),
                         nn.GELU(), FixedBetaLayerNorm(dim * mult),
                         Dense(dim * mult, dim, dtype))
        self.dtype, self.fold = dtype, fold_ln_scale

    def forward(self, x):
        if self.fold:  # both gammas into the next weights (gpt.py:342-353)
            h = self[1](*self[0].parts(x))
            h = self[4](*self[3].parts(self[2](h)))
            return h.to(x.dtype)
        h = self[1](self[0](x).to(self.dtype))
        h = self[4](self[3](self[2](h)).to(self.dtype))
        return h.to(x.dtype)


class CATBlock(nn.ModuleList):
    """One layer: [causal self-attention, cross-attention, feed-forward]
    (reference: gpt_ca.py:268-274,320-323)."""

    def __init__(self, cfg: GPTConfig, dtype: torch.dtype):
        c = cfg
        kw = dict(dtype=dtype, dropout=c.dropout, fold_ln_scale=c.fold_ln_scale)
        super().__init__([
            MultiQueryAttention(c.n_embed, c.n_head, c.dim_head, causal=True,
                                rel_pos_size=c.image_encoded_dim, **kw),
            MultiQueryAttention(c.n_embed, c.n_head, c.dim_head, causal=False,
                                context_dim=c.n_cond_embed, **kw),
            FeedForward(c.n_embed, dtype=dtype, fold_ln_scale=c.fold_ln_scale)])

    @property
    def self_attn(self) -> MultiQueryAttention:
        return self[0]

    @property
    def cross_attn(self) -> MultiQueryAttention:
        return self[1]

    @property
    def ff(self) -> FeedForward:
        return self[2]

    def draw_masks(self, x, context, generator: torch.Generator,
                   keep_prob: float) -> List[torch.Tensor]:
        """Keep masks of this block's four dropouts, in the order the JAX
        block applies them: self-attention q and kv inputs (both shaped as
        x), cross-attention q input (as x) and kv input (as the context)."""
        shapes = [x.shape] * 3 + [context.shape]
        return [torch.rand(s, generator=generator, device=x.device)
                < keep_prob for s in shapes]

    def forward(self, x, context, context_mask,
                masks: Sequence[Optional[torch.Tensor]] = (None,) * 4):
        sq, skv, cq, ckv = masks
        x = self.self_attn(x, keep_q=sq, keep_kv=skv) + x
        x = self.cross_attn(x, context=context, context_mask=context_mask,
                            keep_q=cq, keep_kv=ckv) + x
        return self.ff(x) + x

class GPT(nn.Module):
    """reference: models/gpt_ca.py:250-393."""

    def __init__(self, cfg: GPTConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {cfg.remat!r}; one of "
                             f"{REMAT_POLICIES}")
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

    def forward(self, image_token_ids, text_token_embeds, text_mask, *,
                cond_drop_prob: Optional[float] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cond_keep: Optional[torch.Tensor] = None):
        """Teacher-forced forward -> logits (b, n+1, vocab) (reference:
        gpt_ca.py:284-331; favae_tpu/models/gpt.py:500-529).

        `cond_drop_prob` (default the config's): 0 keeps the text, >= 1
        drops it for every row, in between keeps row b's text where
        `cond_keep[b]`, or, without `cond_keep` (B,) bool, where
        `rand(B) < 1 - cond_drop_prob` is drawn from `generator`. `train`
        applies dropout `cfg.dropout` with masks drawn from `generator`
        (after the conditioning draw, block by block) and checkpoints the
        blocks by `cfg.remat` while gradients are recorded."""
        c = self.cfg
        cond_drop_prob = (c.cond_drop_prob if cond_drop_prob is None
                          else cond_drop_prob)
        x = self._embed_tokens(image_token_ids)
        text_token_embeds = text_token_embeds[:, : c.max_text_len]
        text_mask = text_mask[:, : c.max_text_len]
        if cond_drop_prob >= 1:
            text_mask = torch.zeros_like(text_mask)
        elif cond_drop_prob > 0:
            if cond_keep is None:
                cond_keep = torch.rand(x.shape[0], generator=_need(generator),
                                       device=x.device) < 1.0 - cond_drop_prob
            text_mask = cond_keep[:, None].to(text_mask.device) & text_mask
        # the reference defines a cond_proj Linear but never calls it
        # (gpt_ca.py:259 vs :322): context enters to_kv raw
        x = self.init_norm(x).to(self.dtype)
        context = text_token_embeds.float()
        drop = train and c.dropout > 0
        remat = train and torch.is_grad_enabled()
        for block in self.blocks:
            masks = (block.draw_masks(x, context, _need(generator),
                                      1.0 - c.dropout)
                     if drop else (None,) * 4)
            args = (x, context, text_mask, masks)
            x = self._checkpointed(block, *args) if remat else block(*args)
        return self._logits(self.final_norm(x))

    def _checkpointed(self, block, *args):
        """One block under `cfg.remat`: "none" stores every activation,
        "full" recomputes the block in the backward, "dots" / "dots_nb" save
        the products' outputs (batched ones too / only the non-batched
        projections) and recompute the rest. The block holds no random draw
        (its masks are arguments), so no RNG state is kept for the
        recompute."""
        policy = self.cfg.remat
        if policy == "none":
            return block(*args)
        kw = {}
        if policy in _SAVED_PRODUCTS:
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                functools.partial(_save_products, _SAVED_PRODUCTS[policy]))
        return ckpt.checkpoint(block, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)

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


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a random draw of the GPT forward (dropout, or "
                         "conditioning dropout without cond_keep) needs the "
                         "caller's torch.Generator")
    return generator


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
