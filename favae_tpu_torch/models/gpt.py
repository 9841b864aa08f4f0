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
(L, ...) parameters; here the blocks are a `ModuleList`.

`sample_loop` is the token loop of every CAT sampler: `GPT.sample` runs it
over `block_route`, and `models/decode_engine.py` over that route with the
int8 feed-forward or over the whole-step kernel. Its scan over positions is
one token step that keeps its state in tensors updated in place (the
position a 0-dim tensor, the per-layer KV caches written at it) and makes
no host sync, so that on the card one CUDA graph of it serves every
position (`graphs.run_steps`); the GPT keeps a loop, with its graph, as a
serving plan for later calls with the same key (`models/serving_plan.py`).
In `block_route`'s step each sublayer
boundary (the out-norm, the residual add, the next LayerNorm) and the
feed-forward's middle are one call of `ops/ln_fused.py`, and each attention
sublayer's chain between its projections one call of `ops/mqa_decode.py`:
one kernel launch each on the card, the plain op sequence on the CPU
(`CATBlock.decode`).

Master weights are f32; projections run in `dtype` (bf16 by default) as the
JAX package's Dense layers do. A sampler casts each weight it uses once, not
once a token (`weight_casts`), and its serving plans keep the casts.

Training (`forward(..., train=True)`, favae_tpu/models/gpt.py:203-529):
dropout on the inputs of `to_q` and `to_kv` (separate masks; the FFN has
none, as in the reference), conditioning dropout that drops a row's text
with probability `cond_drop_prob`, `fold_ln_scale` (each pre-projection
LayerNorm's gamma folded into the next projection's weight) and `remat`.
Every random draw comes from the caller's `torch.Generator`, never from the
global RNG: a block's masks are drawn before the block runs, so a block
recomputed under activation checkpointing sees the same masks.

Tensor parallelism (`parallel.sharding.shard_gpt_`, favae_tpu/parallel/
sharding.py): the attention and FF modules get a tp group in `tp` and keep
their slice of `to_q` and `fc1` (by output) and of `to_out` and `fc2` (by
input), so each rank runs `heads / tp` heads and a `1 / tp` slice of the FF
width; the activations enter a split region through `copy_to_tp` and leave
it through `reduce_from_tp`. Where a replicated tensor is used only by this
rank's slice its gradient is partial, and it too goes through `copy_to_tp`:
the shared K/V head (with the null kv), the relative position bias table,
a gamma folded into a split weight. The FF's LayerNorm over the split width
sums its statistics over tp. Without a group (`tp` None) nothing changes.
"""

from __future__ import annotations

import contextlib
import functools
from typing import (Callable, ContextManager, Dict, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from favae_tpu_torch.config import GPTConfig
from favae_tpu_torch.graphs import Graph, run_steps
from favae_tpu_torch.models import serving_plan
from favae_tpu_torch.ops import ln_fused, mqa_decode, rows_gemm
from favae_tpu_torch.ops.mqa_decode import NEG_INF
from favae_tpu_torch.parallel.mesh import all_reduce_sum_grad, spans
from favae_tpu_torch.parallel.sharding import (copy_to_tp, reduce_from_tp,
                                               tp_slice)

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
    weight. `cast` holds the weight already cast while a sampler runs; a
    forward that records gradients raises while it is set. With `cast` in
    bf16, a CUDA input of at most `rows_gemm.MAX_ROWS` rows (a token step's
    projections) takes `ops/rows_gemm.py`'s kernel (`rows_gemm.engages`);
    everything else `F.linear`. `scale`, a per-input-feature vector, is
    folded into the f32 weight first (`W * scale[None, :]` in the (out, in)
    layout; favae_tpu's ScaledDense, gpt.py:83-99)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = compute_dtype
        self.cast: Optional[torch.Tensor] = None

    def forward(self, x, scale: Optional[torch.Tensor] = None):
        if self.cast is not None:
            if torch.is_grad_enabled() or scale is not None:
                raise RuntimeError("Dense.cast is a sampler's detached copy: "
                                   "leave cast_weights() before training")
            w = self.cast
            if rows_gemm.engages(x, w):
                return rows_gemm.rows_linear(x.to(self.compute_dtype), w)
        elif scale is not None:
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

    def forward(self, i: int, j: int,
                row_offset: Optional[Union[int, torch.Tensor]] = None,
                tp=None):
        """Bias (heads, i, j) for a sim of shape (..., i, j); key slot 0 is
        the null kv and gets zero bias. With `row_offset` (incremental
        decoding, i == 1; an int or a 0-dim tensor on the device, gathered
        there) the single query row is the one at that position. With a tp
        group, the bias of this rank's heads only."""
        if row_offset is None:
            rows = self.pos_indices[:i]
        else:
            at = torch.as_tensor(row_offset, device=self.pos_indices.device)
            rows = self.pos_indices.index_select(0, at.view(1))
        bias = F.embedding(rows[:, : j - 1], self.table(tp))  # (i, j-1, heads)
        return F.pad(bias.permute(2, 0, 1), (1, 0))

    def table(self, tp=None) -> torch.Tensor:
        """The bias table ((2 size - 1)^2, heads), or with a tp group
        its columns of this rank's heads."""
        table = self.pos_bias.weight
        return tp_slice(copy_to_tp(table, tp), 1, tp) if spans(tp) else table


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
        self.tp = None  # the tp group, set by parallel.sharding.shard_gpt_

    @property
    def local_heads(self) -> int:
        return self.heads // (self.tp.size if self.tp is not None else 1)

    def _rel_bias(self, i: int, j: int):
        if self.rel_pos_bias is None:
            return None
        return self.rel_pos_bias(i, j, tp=self.tp)[None]

    def _out(self, out, dtype):
        """to_out: the (row-split) projection summed over tp, then its
        LayerNorm."""
        h = reduce_from_tp(self.to_out[1](out), self.tp)
        return self.to_out[2](h).to(dtype)

    def _attend(self, q, kv, *, context_mask=None, causal_offset=None,
                rel_bias=None):
        """q (b, n, h, d); kv (b, m, d) without the null; (b, n, h*d)."""
        b, heads = q.shape[0], q.shape[2]
        null = self.null_kv.to(kv.dtype).expand(b, 1, self.dim_head)
        # the one K/V head serves this rank's heads only under tp
        kv_full = copy_to_tp(torch.cat([null, kv], dim=1), self.tp)
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
        if q_scale is not None:
            q_scale = copy_to_tp(q_scale, self.tp)
        q = self.to_q[1](_dropout(copy_to_tp(x_n, self.tp), keep_q, p),
                         q_scale) * (self.dim_head ** -0.5)
        q = q.reshape(q.shape[0], q.shape[1], self.local_heads, self.dim_head)
        kv = self.to_kv[1](_dropout(ctx, keep_kv, p), kv_scale)
        out = self._attend(q, kv, context_mask=context_mask,
                           causal_offset=0 if self.causal else None,
                           rel_bias=self._rel_bias(q.shape[1],
                                                   kv.shape[1] + 1))
        return self._out(out, x.dtype)

    # ---- incremental decoding -------------------------------------------
    def project_kv(self, context):
        """kv of a static context (the cross-attention cache)."""
        return self.to_kv(context)

    def decode_step(self, x_n, kv_cache, pos: Union[int, torch.Tensor]):
        """One causal self-attention step from x_n (b, 1, dim), this layer's
        input already normalised by `self.norm` and cast to the compute
        dtype (`ln_fused.add_ln` of the boundary before it); kv_cache
        (b, S, dim_head), whose row `pos` (a 0-dim int64 tensor on the
        device, read there; an int is placed in one) is written in place and
        whose rows beyond it are masked. The chain between the projections
        is one `mqa_decode.self_attend` call. Returns to_out's projection
        summed over tp, before its LayerNorm (the next boundary's)."""
        pos = torch.as_tensor(pos, device=kv_cache.device)
        rpb = self.rel_pos_bias
        out = mqa_decode.self_attend(
            self.to_q(copy_to_tp(x_n, self.tp)), self.to_kv(x_n), kv_cache,
            pos, self.null_kv, rpb.table(self.tp), rpb.pos_indices)
        return reduce_from_tp(self.to_out[1](out), self.tp)

    def cross_step(self, x_n, kv, context_mask):
        """One cross-attention step from the normalised x_n against
        precomputed kv (`mqa_decode.cross_attend`); to_out's projection as
        `decode_step`'s."""
        out = mqa_decode.cross_attend(self.to_q(copy_to_tp(x_n, self.tp)),
                                      kv, context_mask, self.null_kv)
        return reduce_from_tp(self.to_out[1](out), self.tp)


def split_layer_norm(h: torch.Tensor, width: int, tp) -> torch.Tensor:
    """LayerNorm without gamma, f32, over a last axis of `width` split over
    tp: this rank's slice `h` normalised by the full rows' mean and biased
    variance (two passes, each summed over tp, forward and backward)."""
    h = h.float()
    mean = all_reduce_sum_grad(h.sum(-1, keepdim=True), tp) / width
    d = h - mean
    var = all_reduce_sum_grad((d * d).sum(-1, keepdim=True), tp) / width
    return d * torch.rsqrt(var + 1e-5)


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
        self.tp = None  # the tp group, set by parallel.sharding.shard_gpt_

    def _forward_split(self, x):
        """The forward on this rank's slice of the 4x width: fc1's output
        columns, the middle LayerNorm's statistics summed over tp, fc2's
        partial product summed over tp."""
        if not self.fold:
            return self._split_from_normed(self[0](x).to(self.dtype),
                                           self[3].gamma).to(x.dtype)
        tp, width = self.tp, self[3].gamma.shape[0]
        gamma_mid = tp_slice(copy_to_tp(self[3].gamma, tp), 0, tp)
        x_n, g_in = self[0].parts(x)
        h = self[1](copy_to_tp(x_n, tp), copy_to_tp(g_in, tp))
        h = self[4](split_layer_norm(self[2](h), width, tp), gamma_mid)
        return reduce_from_tp(h, tp).to(x.dtype)

    def _split_from_normed(self, x_n, gamma_mid):
        tp, width = self.tp, self[3].gamma.shape[0]
        gamma_mid = tp_slice(copy_to_tp(gamma_mid, tp), 0, tp)
        h = self[1](copy_to_tp(x_n, tp))
        h = split_layer_norm(self[2](h), width, tp) * gamma_mid
        return reduce_from_tp(self[4](h.to(self.dtype)), tp)

    def forward(self, x):
        if spans(self.tp):
            return self._forward_split(x)
        if self.fold:  # both gammas into the next weights (gpt.py:342-353)
            h = self[1](*self[0].parts(x))
            h = self[4](*self[3].parts(self[2](h)))
            return h.to(x.dtype)
        h = self[1](self[0](x).to(self.dtype))
        h = self[4](self[3](self[2](h)).to(self.dtype))
        return h.to(x.dtype)

    def step_gamma(self, i: int) -> torch.Tensor:
        """The gamma the token step's LayerNorm `self[i]` (0: before fc1,
        3: before fc2) applies: its own, or ones under `fold_ln_scale`,
        whose gammas `cast_weights` folds into fc1's and fc2's casts, as the
        JAX package's decode runs the fold (favae_tpu/models/gpt.py:
        343-352)."""
        gamma = self[i].gamma
        return torch.ones_like(gamma) if self.fold else gamma

    def decode(self, x_n):
        """The feed-forward of one token step from x_n, its input already
        normalised by `self[0]` (`step_gamma(0)`) and cast to the compute
        dtype: fc1, GELU and the middle LayerNorm (`ln_fused.gelu_ln`, or
        its statistics summed over tp), fc2. Returns fc2's product summed
        over tp, before the residual."""
        if spans(self.tp):
            return self._split_from_normed(x_n, self.step_gamma(3))
        return self[4](ln_fused.gelu_ln(self[1](x_n), self.step_gamma(3),
                                        self.dtype))


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

    def decode(self, x, x_n, cache, cross_kv, context_mask,
               pos: Union[int, torch.Tensor], gamma_next: torch.Tensor,
               out_dtype: torch.dtype,
               ffn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """Incremental step: x (b, 1, dim) the residual stream and x_n its
        self-attention input, normalised (`decode_step`); cache (b, S, dh),
        written in place at `pos` (an int or a 0-dim int64 tensor on the
        device); cross_kv (b, m, dh). Returns (x after the layer, x
        normalised by `gamma_next`, the next LayerNorm's, in `out_dtype`).
        Each sublayer boundary (its out-norm, the residual add, the next
        sublayer's norm) is one `ln_fused.add_ln` call: its inputs are
        summed over tp before it, so every rank computes the same. `ffn`,
        from x to x after the feed-forward and its residual add, replaces
        the block's own feed-forward."""
        sa, ca, ff = self
        x, x_n = ln_fused.add_ln(sa.decode_step(x_n, cache, pos), x,
                                 sa.to_out[2].gamma, ca.norm.gamma, ca.dtype)
        x, x_n = ln_fused.add_ln(ca.cross_step(x_n, cross_kv, context_mask),
                                 x, ca.to_out[2].gamma, ff.step_gamma(0),
                                 ff.dtype)
        if ffn is not None:
            return ln_fused.add_ln(ffn(x), None, None, gamma_next, out_dtype)
        return ln_fused.add_ln(ff.decode(x_n), x, None, gamma_next, out_dtype)


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

    def cast_weights(self):
        """`cast_weights` of every Dense of the GPT."""
        return cast_weights(self)

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

    # ------------------------------------------------------------------
    def sample(self, text_token_embeds, text_mask, **kw):
        """Autoregressive sampling with KV caches (functionally the
        reference's gpt_ca.py:343-367, which re-forwards the prefix for every
        token): `sample_loop` over `EXACT` (`block_route`), with its
        keywords."""
        return sample_loop(self, text_token_embeds, text_mask, EXACT, **kw)


def weight_casts(*modules: nn.Module) -> Dict[Dense, torch.Tensor]:
    """Every Dense weight under `modules` cast once to its compute dtype, by
    module. A feed-forward built with `fold_ln_scale` has the gammas of the
    LayerNorms before fc1 and fc2 folded into their casts, as `Dense`'s
    `scale` folds them (fc2's gamma this rank's slice under tp;
    `FeedForward.step_gamma`)."""
    mods = [m for mod in modules for m in mod.modules()]
    dense = {m: None for m in mods if isinstance(m, Dense)}
    for ff in mods:
        if isinstance(ff, FeedForward) and ff.fold:
            dense[ff[1]] = ff[0].gamma
            dense[ff[4]] = tp_slice(ff[3].gamma, 0, ff.tp)
    casts = {}
    for m, scale in dense.items():
        w = m.weight.detach()
        if scale is not None:
            w = w * scale.detach()[None, :]
        casts[m] = w.to(m.compute_dtype)
    return casts


@contextlib.contextmanager
def using_casts(casts: Dict[Dense, torch.Tensor]):
    """While inside, each Dense of `casts` uses its cast weight
    (`Dense.cast`) instead of casting on each call; on leaving, each has
    what it had before."""
    before = {m: m.cast for m in casts}
    try:
        for m, w in casts.items():
            m.cast = w
        yield
    finally:
        for m, w in before.items():
            m.cast = w


def cast_weights(*modules: nn.Module) -> ContextManager[None]:
    """While inside, every Dense under `modules` uses its weight cast once to
    its compute dtype (`weight_casts`) instead of casting on each call."""
    return using_casts(weight_casts(*modules))


class Route(NamedTuple):
    """A route of `sample_loop`. `name` keys its serving plans
    (`models/serving_plan.py`); `casts(gpt)` gives the modules whose Dense
    weights its step uses cast (`weight_casts`); `build(gpt, context, mask,
    casts, prepared)`, over the doubled context (f32) and mask, which it
    keeps and reads again, those casts and the route's prepared weights
    (`sample_loop`'s `prepared`), returns (step, refill): step, (x, pos) ->
    logits, x (2B, dim) f32 the embedded previous tokens, pos the 0-dim
    position, logits (2B, vocab) f32, writes the route's caches in place;
    refill() recomputes from the context and mask what the step reads of
    them (the cross K/V) and zeroes the caches."""
    name: str
    casts: Callable[["GPT"], Sequence[nn.Module]]
    build: Callable[..., Tuple[Callable, Callable[[], None]]]


def block_route(gpt: GPT, context, mask, casts: Dict[Dense, torch.Tensor],
                prepared=None, ffns: Optional[Sequence[Callable]] = None):
    """The exact route (`EXACT`): `add_ln` into `init_norm` and the first
    layer's norm, every layer's `CATBlock.decode`, the tied head on
    `final_norm`'s output, the Dense weights it uses from `casts`. `ffns`,
    one callable a layer (`CATBlock.decode`'s `ffn`), replaces the blocks'
    feed-forwards (the `qparams` route of `models/decode_engine.py`)."""
    c, blocks = gpt.cfg, gpt.blocks

    def cross_kv_now():
        with using_casts(casts):
            return [blk.cross_attn.project_kv(context) for blk in blocks]

    cross_kv = cross_kv_now()
    caches = torch.zeros((c.n_layer, context.shape[0],
                          c.image_encoded_dim ** 2, c.dim_head),
                         dtype=gpt.dtype, device=context.device)
    # the LayerNorm each boundary ends in: every layer's self-attention
    # norm, then final_norm (f32, for the logits)
    norms = [blk.self_attn.norm.gamma for blk in blocks] + [
        gpt.final_norm.gamma]

    def step(x, pos):
        with using_casts(casts):
            x, x_n = ln_fused.add_ln(x[:, None], None, gpt.init_norm.gamma,
                                     norms[0], gpt.dtype)
            for l, blk in enumerate(blocks):
                x, x_n = blk.decode(
                    x, x_n, caches[l], cross_kv[l], mask, pos, norms[l + 1],
                    torch.float32 if l + 1 == c.n_layer else gpt.dtype,
                    None if ffns is None else ffns[l])
            return gpt._logits(x_n[:, 0])

    def refill():
        for kv, now in zip(cross_kv, cross_kv_now()):
            kv.copy_(now)
        caches.zero_()

    return step, refill


EXACT = Route("exact", lambda gpt: [gpt], block_route)


class TokenLoop:
    """The token loop of one request shape and one set of sampler settings
    over a route: the doubled context and mask the route's step reads
    (`load` copies a later request's in), the loop state (the position,
    the previous tokens, the grid) and the token step over them, which
    updates its state in place and makes no host sync, and the refill of
    what the route derives from the context, its caches and the state; on
    the card, once run, the captured graphs of both (`graphs.Graph`). A
    serving plan (`models/serving_plan.py`) is one, kept across
    requests."""

    def __init__(self, gpt: GPT, route: Route, context, mask,
                 casts: Dict[Dense, torch.Tensor], prepared,
                 sampler: Tuple, *, noise: Optional[torch.Tensor] = None,
                 forced: Optional[torch.Tensor] = None,
                 return_logits: bool = False):
        c, dev = gpt.cfg, context.device
        rows, seq_len = context.shape[0], c.image_encoded_dim ** 2
        b = rows // 2
        top_k, top_p, temperature, cond_scale = sampler
        self.dev, self.seq_len, self.side = dev, seq_len, c.image_encoded_dim
        self.context, self.mask = context, mask
        step, self.refill_route = route.build(gpt, context, mask, casts,
                                              prepared)
        self.noised = noise is not None
        self.graph: Optional[Graph] = None
        self.own: Optional[torch.Generator] = None
        self.draws: Optional[torch.Generator] = None
        state = self.state = dict(
            pos=torch.zeros((), dtype=torch.long, device=dev),
            tok_prev=torch.zeros((rows,), dtype=torch.long, device=dev),
            tokens=torch.zeros((b, seq_len), dtype=torch.long, device=dev))
        if return_logits:
            state["logits"] = torch.zeros((b, seq_len, c.vocab_size),
                                          dtype=torch.float32, device=dev)
        noise_all = None if noise is None else noise.to(dev)
        forced_all = None if forced is None else forced.to(dev).long()
        axial = gpt._axial_pos()
        start = gpt.start_token.expand(rows, -1)

        def token_step():
            pos = state["pos"]
            at = pos.view(1)
            prev = gpt.tok_emb(state["tok_prev"]) + axial.index_select(
                0, (pos - 1).clamp(min=0).view(1))
            logits2 = step(torch.where(pos == 0, start, prev), pos)
            cond, null = logits2[:b], logits2[b:]
            logits = (cond if cond_scale == 1
                      else null + (cond - null) * cond_scale)
            tok = gumbel_sample(
                top_k_top_p_filter(logits, top_k, top_p), self.draws,
                temperature,
                None if noise_all is None
                else noise_all.index_select(0, at)[0])
            carry = (tok if forced_all is None
                     else forced_all.index_select(1, at)[:, 0])
            state["tok_prev"].copy_(torch.cat([carry, carry], 0))
            state["tokens"].index_copy_(1, at, tok[:, None])
            if return_logits:
                state["logits"].index_copy_(1, at, logits[:, None])
            pos.add_(1)

        self.token_step = token_step

    def refill(self) -> None:
        """Recompute what the route's step reads of the context and mask,
        zero its caches and the loop state: what a kept loop's run sets up
        before its first token."""
        self.refill_route()
        for t in self.state.values():
            t.zero_()

    def load(self, context, mask) -> None:
        """A later request's doubled context and mask, copied in; its run
        refills from them (`refill`)."""
        self.context.copy_(context)
        self.mask.copy_(mask)

    def run(self, generator: Optional[torch.Generator],
            on_token: Optional[Callable[[int], None]] = None, *,
            eager: bool = False, keep: bool = False) -> None:
        """Every token of a request, drawing from `generator`, `on_token(i)`
        once token i is queued: `eager`, a call of the step each (a tp
        group's collectives, which a graph does not capture); else through
        `graphs.run_steps`. With `keep` (a serving plan) the run refills
        first, and on the card the graphs are kept and replayed in a later
        run (`_replay`)."""
        draws = None if self.noised else generator
        if eager:
            if draws is not None and draws.device.type != self.dev.type:
                raise ValueError(f"the token loop on {self.dev} cannot draw "
                                 f"from a generator on {draws.device}")
            self.draws = generator
            for i in range(self.seq_len):   # collectives: no graph, no sync
                self.token_step()
                if on_token is not None:
                    on_token(i)
        elif keep and self.dev.type == "cuda":
            self._replay(generator, on_token)
            return
        else:
            self.draws = generator
            run_steps(self.token_step, self.seq_len, self.dev, generator=draws,
                      after=on_token, before=self.refill if keep else None)
        self.draws = None

    def _replay(self, generator: Optional[torch.Generator],
                on_token: Optional[Callable[[int], None]]) -> None:
        """A kept loop's run on the card: the first run captures the token
        step's graph and the refill's (`run_steps`' `before`); a later run
        replays the refill's, then the token step's for every token
        (`graphs.Graph.run`). The
        graphs draw from a generator of the loop's own, registered with
        them at the capture: the caller's state (the default generator's
        where `generator` is None) is moved into that one before the first
        token and back out after the last, so that the caller's generator
        gives and advances as graphs captured for this request would make
        it."""
        caller = (torch.cuda.default_generators[self.dev.index]
                  if generator is None else generator)
        if caller.device.type != "cuda":
            raise ValueError(f"the token loop's graph on {self.dev} cannot "
                             f"draw from a generator on {caller.device}")
        if self.own is None:
            self.own = self.draws = torch.Generator(device=self.dev)
        self.own.set_state(caller.get_state())
        if self.graph is None:
            self.graph = run_steps(self.token_step, self.seq_len, self.dev,
                                   generator=self.own, after=on_token,
                                   before=self.refill)
        else:
            self.graph.run(self.seq_len, on_token)
        caller.set_state(self.own.get_state())

    def result(self):
        """The (B, grid, grid) int64 token grid, a copy, and with
        `return_logits` the CFG logits (B, S, vocab)."""
        grid = self.state["tokens"].reshape(-1, self.side, self.side).clone()
        if "logits" in self.state:
            return grid, self.state["logits"]
        return grid


@torch.inference_mode()
def sample_loop(gpt: GPT, text_token_embeds, text_mask, route: Route, *,
                prepared=None, generator: Optional[torch.Generator] = None,
                temperature: float = 1.0, top_k: Optional[int] = None,
                top_p: float = 1.0, cond_scale: float = 3.0,
                gumbel_noise: Optional[torch.Tensor] = None,
                forced_tokens: Optional[torch.Tensor] = None,
                return_logits: bool = False,
                on_token: Optional[Callable[[int], None]] = None):
    """The token loop of every CAT sampler. CFG runs as a 2B batch: rows
    [0:B] conditional, [B:2B] with an all-false text mask. `route` (a
    `Route`) builds the step, (x, pos) -> logits, over the doubled context
    and mask; `prepared`, the route's prepared weights (`quantize_decode_
    params`', `prepare_fused_decode`'s; None on the exact route). Returns
    the (B, grid, grid) int64 token grid.

    `gumbel_noise` (S, B, vocab) replaces the generator's draws;
    `on_token(pos)` is called after each token's work is queued. Audit
    hooks: `forced_tokens` (B, S) teacher-forces the context after each
    free sample is recorded, so that two engines' logits can be compared;
    `return_logits=True` also returns the CFG logits (B, S, vocab) before
    top-k/top-p.

    The token step keeps its state in tensors that it updates in place
    and makes no host sync, as the JAX package's `lax.scan` over positions
    (favae_tpu/models/gpt.py:592): on the card `graphs.run_steps` replays
    one CUDA graph of it, drawing anew from a registered CUDA `generator`
    (a CPU generator raises). Under a tp group of more than one rank the
    step holds collectives, which a graph does not capture, and runs
    eagerly, still with no host sync. On the CPU it runs eagerly.

    A call keeps its loop in the GPT's serving plans (`models/serving_
    plan.py`): the route's Dense casts and `prepared`, where the GPT's
    store made it (`serving_plan.weights`), once for every key of the
    route, and the `TokenLoop`, with the graph on the card, for the key of
    the route, the device, the dtype, the doubled context's shape and the
    sampler settings. A later call with the key copies its context and mask
    in and replays two graphs: the refill of the cross K/V with the zeroing
    of the caches and the state, then the token step's for every token;
    the caller's generator gives the draws and is advanced as without a
    plan. The audit hooks, the
    noise, a tp group that spans ranks and prepared weights of the caller's
    own run without a plan, each call anew."""
    c = gpt.cfg
    text_token_embeds = text_token_embeds[:, : c.max_text_len]
    text_mask = text_mask[:, : c.max_text_len]
    ctx2 = torch.cat([text_token_embeds, text_token_embeds], 0).float()
    mask2 = torch.cat([text_mask, torch.zeros_like(text_mask)], 0)
    sampler = (top_k, top_p, temperature, cond_scale)
    eager = spans(gpt.blocks[0].self_attn.tp)
    store = None
    if not (eager or return_logits or gumbel_noise is not None
            or forced_tokens is not None):
        store = serving_plan.store(gpt)
        if prepared is not None and not store.owns(prepared):
            store = None
    if store is None:
        loop = TokenLoop(gpt, route, ctx2, mask2,
                         weight_casts(*route.casts(gpt)), prepared, sampler,
                         noise=gumbel_noise, forced=forced_tokens,
                         return_logits=return_logits)
        loop.run(generator, on_token, eager=eager)
        return loop.result()
    casts = store.prepared("casts." + route.name,
                           lambda: weight_casts(*route.casts(gpt)))
    key = (route.name, ctx2.device, gpt.dtype, tuple(ctx2.shape),
           mask2.dtype, *sampler)
    loop, kept = store.plan(key, lambda: TokenLoop(
        gpt, route, ctx2, mask2, casts, prepared, sampler))
    if kept:
        loop.load(ctx2, mask2)
    loop.run(generator, on_token, keep=True)
    return loop.result()


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a random draw of the GPT forward (dropout, or "
                         "conditioning dropout without cond_keep) needs the "
                         "caller's torch.Generator")
    return generator


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
