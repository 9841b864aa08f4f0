"""Vector quantizer with EMA codebooks (port of
favae_tpu/models/quantizer.py).

The codebook lives in buffers named as the reference's codebook
(`quantizer._codebook.embed` with a leading num_codebooks axis of 1,
favae_tpu/utils/torch_export.py:148-155), so a reference-format state_dict
loads strictly; `CodebookState` is the same codebook as plain tensors, the
form the JAX package passes around. All quantizer math is f32.

`codebook_lookup(train=True)` returns the EMA-updated state as new tensors,
as the JAX package does; the train step then copies it into the module's
buffers in place (`VectorQuantize.set_state`).

Every temperature-0 lookup goes to `ops.vq` (the CUDA kernel on the card).
The JAX package gates its TPU kernel on N*K >= 2^22
(favae_tpu/models/quantizer.py:138-143) because a small Pallas call costs
more than XLA's fused matmul + argmax there; on the card the kernel needs no
(N, K) scores in device memory at any size, so the port has no gate.

The train options take their random draws as arguments (`QuantizerDraws`,
made by `draw_quantizer` from the caller's `torch.Generator`, or the JAX
package's own draws in the parity tests): gumbel noise for a temperature
above 0 (whose lookup materialises the scores, as the JAX gate at
favae_tpu/models/quantizer.py:151 does), the expiry candidates and the
orthogonal regulariser's code sample. `kmeans` takes its first permutation
the same way; on the card each assignment step goes through `ops.vq`.

Under data parallelism (`dp`, a `parallel.mesh.Group`) each rank holds its
rows of the global batch, and the train-mode lookup computes what the JAX
package's global-view step computes over the whole batch
(favae_tpu/models/quantizer.py:7-9): the EMA's bins and sums are summed
over dp before the update, the draws are the global batch's (the gumbel
noise's rows are cut to this rank's, the expiry candidates index the
global rows, which are fetched from the rank that holds them), and every
rank ends with the same state. k-means runs on the gathered first batch
(`train/favae_trainer.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import QuantizerConfig
from favae_tpu_torch.parallel.mesh import (all_reduce_sum,
                                           all_reduce_sum_grad, rows_of)
from favae_tpu_torch.ops.vq import vq_nearest_cosine, vq_nearest_euclidean


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis (favae_tpu quantizer.py:35-38)."""
    return F.normalize(t, dim=-1, eps=eps)


@dataclasses.dataclass
class CodebookState:
    """One codebook as plain f32 tensors: embed (K, D), cluster_size (K,),
    embed_avg (K, D)."""

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor


def init_codebook_state(cfg: QuantizerConfig,
                        generator: Optional[torch.Generator] = None
                        ) -> CodebookState:
    """kaiming_uniform over (K, D), bound 1/sqrt(D), l2-normalised for the
    cosine codebook (favae_tpu quantizer.py:88-102)."""
    d = cfg.codebook_dim or cfg.dim
    k = cfg.codebook_size
    bound = 1.0 / d ** 0.5
    embed = (torch.rand((k, d), generator=generator) * 2.0 - 1.0) * bound
    if cfg.use_cosine_sim:
        embed = l2norm(embed)
    return CodebookState(embed=embed, cluster_size=torch.zeros(k),
                         embed_avg=embed.clone())


def laplace_smoothing(x: torch.Tensor, n_categories: int,
                      eps: float = 1e-5) -> torch.Tensor:
    return (x + eps) / (torch.sum(x, dim=-1, keepdim=True)
                        + n_categories * eps)


def code_stats(flatten: torch.Tensor, idx: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code counts (K,) and sums (K, D) by `index_add_`
    (favae_tpu/models/quantizer.py:174-179)."""
    bins = torch.zeros(k, dtype=torch.float32, device=flatten.device)
    bins.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    sums = torch.zeros((k, flatten.shape[-1]), dtype=torch.float32,
                       device=flatten.device)
    sums.index_add_(0, idx, flatten)
    return bins, sums


@dataclasses.dataclass
class QuantizerDraws:
    """The random draws of one train-mode lookup, each None where its
    option is off: gumbel noise (N, K) f32 for `sample_codebook_temp` > 0,
    the expiry candidates (K,) int64 in [0, N) for
    `threshold_ema_dead_code` > 0, and the orthogonal regulariser's codes
    (`orthogonal_reg_max_codes`,) int64 (favae_tpu/models/quantizer.py:
    151-154, 194, 309-312)."""

    gumbel: Optional[torch.Tensor] = None
    candidates: Optional[torch.Tensor] = None
    ortho_codes: Optional[torch.Tensor] = None


def draw_quantizer(cfg: QuantizerConfig, n: int,
                   generator: torch.Generator) -> QuantizerDraws:
    """What a train-mode lookup of `n` vectors draws under `cfg`, from
    `generator` on its device; nothing where every option is off."""
    dev, k = generator.device, cfg.codebook_size
    draws = QuantizerDraws()
    if cfg.sample_codebook_temp != 0.0:
        # jax.random.gumbel: -log(-log(u)), u uniform in [tiny, 1)
        u = torch.rand((n, k), generator=generator, device=dev)
        draws.gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
    if cfg.threshold_ema_dead_code > 0:
        draws.candidates = torch.randint(0, n, (k,), generator=generator,
                                         device=dev)
    m = cfg.orthogonal_reg_max_codes
    if (cfg.orthogonal_reg_weight > 0
            and not cfg.orthogonal_reg_active_codes_only
            and m is not None and m < k):
        draws.ortho_codes = torch.randperm(k, generator=generator,
                                           device=dev)[:m]
    return draws


def gumbel_sample(logits: torch.Tensor, noise: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """argmax(logits / temperature + noise) over the last axis
    (favae_tpu/models/quantizer.py:45-51, the noise drawn by the caller)."""
    return torch.argmax(logits / temperature + noise, dim=-1)


def orthogonal_loss_fn(codes: torch.Tensor) -> torch.Tensor:
    """((C_n C_n^T - I)^2).sum / n^2 over l2-normalised codes
    (favae_tpu/models/quantizer.py:54-61)."""
    n = codes.shape[0]
    normed = l2norm(codes)
    sim = normed @ normed.T
    eye = torch.eye(n, dtype=sim.dtype, device=sim.device)
    return torch.sum((sim - eye) ** 2) / (n * n)


def masked_orthogonal_loss_fn(codes: torch.Tensor,
                              active: torch.Tensor) -> torch.Tensor:
    """The orthogonal loss over active x active pairs, divided by
    n_active^2 (favae_tpu/models/quantizer.py:64-77)."""
    normed = l2norm(codes)
    sim = normed @ normed.T
    eye = torch.eye(codes.shape[0], dtype=sim.dtype, device=sim.device)
    m = active.to(sim.dtype)
    n_active = torch.clamp(m.sum(), min=1.0)
    return torch.sum((sim - eye) ** 2 * (m[:, None] * m[None, :])) / (
        n_active * n_active)


def kmeans_assign(samples: torch.Tensor, means: torch.Tensor,
                  use_cosine_sim: bool, plain: bool = False) -> torch.Tensor:
    """The nearest mean of each sample, int64. On the card through
    `ops.vq` (argmax x.e for cosine, argmax 2 x.e - |e|^2 for euclidean,
    which ranks as -||x - e|| does); on the CPU, or with `plain`, by the
    JAX package's formulas (favae_tpu/models/quantizer.py:116-120), which
    materialise (N, K) scores, and for euclidean an (N, K, D) difference."""
    if samples.device.type == "cpu" or plain:
        if use_cosine_sim:
            dists = samples @ means.T
        else:
            dists = -torch.linalg.vector_norm(
                samples[:, None, :] - means[None, :, :], dim=-1)
        return torch.argmax(dists, dim=-1)
    near = vq_nearest_cosine if use_cosine_sim else vq_nearest_euclidean
    return near(samples, means.contiguous()).long()


@torch.no_grad()
def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int,
           use_cosine_sim: bool, first: torch.Tensor, plain: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means for the codebook init (favae_tpu/models/quantizer.py:
    105-134): samples (N, D) f32 (l2-normalised for cosine), the first
    means at the indices `first[:num_clusters]` (a permutation of N drawn
    by the caller) -> (means (K, D), bins (K,) f32 of the last assignment).
    Empty clusters keep their mean. The JAX function cannot run with fewer
    samples than clusters (its update divides (N, D) sums by K bins); this
    one says so."""
    n = samples.shape[0]
    if n < num_clusters:
        raise ValueError(f"k-means codebook init needs at least as many "
                         f"codebook inputs as codes: N = {n} < K = "
                         f"{num_clusters}")
    samples = samples.float().contiguous()
    means = samples[first[:num_clusters]]
    for _ in range(num_iters):
        buckets = kmeans_assign(samples, means, use_cosine_sim, plain)
        bins, sums = code_stats(samples, buckets, num_clusters)
        new_means = sums / torch.clamp(bins, min=1.0)[:, None]
        if use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where((bins == 0)[:, None], means, new_means)
    buckets = kmeans_assign(samples, means, use_cosine_sim, plain)
    bins, _ = code_stats(samples, buckets, num_clusters)
    return means, bins


def _global_rows(flatten: torch.Tensor, index: torch.Tensor,
                 dp) -> torch.Tensor:
    """Rows `index` of the global batch's (N_global, D) rows, of which
    this rank holds `flatten`: each rank gives the rows it holds (zeros
    elsewhere) to a sum over dp, which carries their gradient back."""
    if dp is None:
        return flatten[index]
    n = flatten.shape[0]
    local = index - dp.rank * n
    mine = (local >= 0) & (local < n)
    rows = flatten[local.clamp(0, n - 1)] * mine[:, None].to(flatten.dtype)
    return all_reduce_sum_grad(rows, dp)


def _expire_dead_codes(cfg: QuantizerConfig, state: CodebookState,
                       flatten: torch.Tensor, candidates: torch.Tensor,
                       dp=None) -> CodebookState:
    """Codes whose EMA count fell below the threshold take the
    l2-normalised batch vectors at `candidates`, count = the threshold
    (favae_tpu/models/quantizer.py:182-203)."""
    thr = cfg.threshold_ema_dead_code
    expired = state.cluster_size < thr
    cand = l2norm(_global_rows(flatten, candidates, dp))
    return CodebookState(
        embed=torch.where(expired[:, None], cand, state.embed),
        cluster_size=torch.where(expired, thr, state.cluster_size),
        embed_avg=torch.where(expired[:, None], cand * thr, state.embed_avg))


def _nearest_codes(cfg: QuantizerConfig, flatten: torch.Tensor,
                   embed: torch.Tensor,
                   noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Indices (N,) int64 of the nearest codes; embed l2-normalised by the
    caller for cosine (favae_tpu/models/quantizer.py:137-171)."""
    temp = cfg.sample_codebook_temp
    if temp == 0.0:
        near = (vq_nearest_cosine if cfg.use_cosine_sim
                else vq_nearest_euclidean)
        return near(flatten, embed).long()
    if cfg.use_cosine_sim:
        dist = flatten @ embed.T
    else:
        x2 = torch.sum(flatten * flatten, dim=-1, keepdim=True)
        e2 = torch.sum(embed * embed, dim=-1)
        dist = -(x2 - 2.0 * flatten @ embed.T + e2[None, :])
    if noise is not None:
        return gumbel_sample(dist, noise, temp)
    return torch.argmax(dist, dim=-1)


def _ema_update(cfg: QuantizerConfig, state: CodebookState,
                flatten: torch.Tensor, embed_n: Optional[torch.Tensor],
                idx: torch.Tensor, dp=None) -> CodebookState:
    """The new EMA state (favae_tpu/models/quantizer.py:223-257), from
    the bins and sums of the global batch under `dp`."""
    k, decay = cfg.codebook_size, cfg.decay
    bins, embed_sum = code_stats(flatten, idx, k)
    if dp is not None:
        stats = all_reduce_sum_grad(torch.cat([bins[:, None], embed_sum], 1),
                                    dp)
        # contiguous, as code_stats gives them: the same reductions follow
        bins, embed_sum = stats[:, 0].contiguous(), stats[:, 1:].contiguous()
    cluster = state.cluster_size * decay + bins * (1.0 - decay)
    if cfg.use_cosine_sim:
        # normalised batch means; empty bins keep the current code
        zero = (bins == 0)[:, None]
        normed = l2norm(embed_sum / torch.where(bins == 0, 1.0, bins)[:, None])
        normed = torch.where(zero, embed_n, normed)
        embed = state.embed * decay + normed * (1.0 - decay)
        return CodebookState(embed=embed, cluster_size=cluster,
                             embed_avg=state.embed_avg)
    if cfg.compat_stale_embed_avg:
        avg = state.embed_avg  # the reference never updates it
    else:
        avg = state.embed_avg * decay + embed_sum * (1.0 - decay)
    smoothed = laplace_smoothing(cluster, k, cfg.eps) * torch.sum(cluster)
    return CodebookState(embed=avg / smoothed[:, None], cluster_size=cluster,
                         embed_avg=avg)


def codebook_lookup(cfg: QuantizerConfig, state: CodebookState,
                    x: torch.Tensor, *, train: bool = False,
                    draws: Optional[QuantizerDraws] = None, dp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, CodebookState]:
    """Quantize (N, D) -> (quantize (N, D) f32, indices (N,) int64, state),
    the state EMA-updated when `train` and then dead codes expired where
    `draws` has candidates (cosine: reference models/l2_quantize.py:391-444;
    euclidean: :264-306). The lookup needs no gradient. With the orthogonal
    regulariser on, the new state keeps its graph to `x`, as the JAX
    package's does: the regulariser of the new codes then passes its
    gradient through the EMA update (the reference's torch buffers pass
    none). Under `dp`, `x` is this rank's rows of the global batch and
    `draws` the global batch's."""
    draws = draws or QuantizerDraws()
    x = x.float()
    noise = draws.gumbel
    if noise is not None:
        noise = rows_of(noise, dp, x.shape[0])
    with torch.no_grad():
        if cfg.use_cosine_sim:
            embed_n = l2norm(state.embed)
            idx = _nearest_codes(cfg, l2norm(x), embed_n, noise)
        else:
            embed_n = None
            idx = _nearest_codes(cfg, x, state.embed, noise)
        quantize = state.embed[idx]  # the codes before this step's update
    if train:
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and cfg.orthogonal_reg_weight > 0):
            flatten = l2norm(x) if cfg.use_cosine_sim else x
            state = _ema_update(cfg, state, flatten, embed_n, idx, dp)
            if (cfg.threshold_ema_dead_code > 0
                    and draws.candidates is not None):
                state = _expire_dead_codes(cfg, state, flatten,
                                           draws.candidates, dp)
    return quantize, idx, state


class _Codebook(nn.Module):
    """Buffers of the reference's CosineSimCodebook / EuclideanCodebook."""

    def __init__(self, k: int, d: int, euclidean: bool):
        super().__init__()
        self.register_buffer("initted", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(1, k))
        self.register_buffer("embed", torch.zeros(1, k, d))
        if euclidean:
            self.register_buffer("embed_avg", torch.zeros(1, k, d))


class VectorQuantize(nn.Module):
    """Image-fmap vector quantizer (reference: models/l2_quantize.py:448-595)
    with the optional f32 `project_in`/`project_out`."""

    def __init__(self, cfg: QuantizerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.codebook_dim or cfg.dim
        if cfg.codebook_dim is not None and cfg.codebook_dim != cfg.dim:
            self.project_in = nn.Linear(cfg.dim, cfg.codebook_dim)
            self.project_out = nn.Linear(cfg.codebook_dim, cfg.dim)
        else:
            self.project_in = self.project_out = None
        self._codebook = _Codebook(cfg.codebook_size, d,
                                   euclidean=not cfg.use_cosine_sim)
        self.dp = None  # the dp group of a data-parallel run

    def state(self) -> CodebookState:
        cb = self._codebook
        embed = cb.embed[0]
        avg = cb.embed_avg[0] if hasattr(cb, "embed_avg") else embed
        return CodebookState(embed=embed, cluster_size=cb.cluster_size[0],
                             embed_avg=avg)

    @torch.no_grad()
    def set_state(self, state: CodebookState) -> None:
        cb = self._codebook
        cb.embed.copy_(state.embed[None])
        cb.cluster_size.copy_(state.cluster_size[None])
        if hasattr(cb, "embed_avg"):
            cb.embed_avg.copy_(state.embed_avg[None])

    def forward(self, x: torch.Tensor, state: Optional[CodebookState] = None,
                *, train: bool = False,
                draws: Optional[QuantizerDraws] = None):
        """x (B, C=dim, H, W) -> (quantized (B, dim, H, W) f32 channels_last,
        indices (B, H, W) int64, loss (scalar f32), new state). `state`
        defaults to the module's codebook. With `train` the output is the
        straight-through estimate, the loss the weighted commitment loss plus
        the weighted orthogonal regulariser of the new codes (whose gradient
        reaches `x` through the EMA update, as in the JAX package), and the
        state EMA-updated (favae_tpu/models/quantizer.py:281-319)."""
        cfg = self.cfg
        state = state or self.state()
        b, c, h, w = x.shape
        z = x.permute(0, 2, 3, 1).reshape(b * h * w, c).float()
        if self.project_in is not None:
            z = self.project_in(z)
        quantize, idx, state = codebook_lookup(cfg, state, z, train=train,
                                               draws=draws, dp=self.dp)
        loss = torch.zeros((), dtype=torch.float32, device=z.device)
        if train:
            quantize = z + (quantize - z).detach()
            if cfg.commitment_weight > 0:
                commit = torch.mean((quantize.detach() - z) ** 2)
                loss = loss + commit * cfg.commitment_weight
            if cfg.orthogonal_reg_weight > 0:
                loss = loss + self._orthogonal_loss(state.embed, idx, draws) \
                    * cfg.orthogonal_reg_weight
        if self.project_out is not None:
            quantize = self.project_out(quantize)
        out = quantize.reshape(b, h, w, cfg.dim).permute(0, 3, 1, 2)
        return out, idx.reshape(b, h, w), loss, state

    def _orthogonal_loss(self, codes: torch.Tensor, idx: torch.Tensor,
                         draws: Optional[QuantizerDraws]) -> torch.Tensor:
        """Over the codes this batch used, or the drawn sample of
        `orthogonal_reg_max_codes`, or all (favae_tpu quantizer.py:300-314)."""
        if self.cfg.orthogonal_reg_active_codes_only:
            active = torch.zeros(codes.shape[0], dtype=torch.bool,
                                 device=codes.device)
            active[idx] = True
            if self.dp is not None:  # the codes the global batch used
                active = all_reduce_sum(active.float(), self.dp) > 0
            return masked_orthogonal_loss_fn(codes, active)
        if draws is not None and draws.ortho_codes is not None:
            return orthogonal_loss_fn(codes[draws.ortho_codes])
        return orthogonal_loss_fn(codes)

    def decode_indices(self, indices: torch.Tensor,
                       state: Optional[CodebookState] = None) -> torch.Tensor:
        """Indices (B, H, W) -> codebook entries (B, dim, H, W), projected
        back to `dim` (favae_tpu quantizer.py:321-329)."""
        state = state or self.state()
        z = state.embed[indices]
        if self.project_out is not None:
            z = self.project_out(z)
        return z.permute(0, 3, 1, 2)
