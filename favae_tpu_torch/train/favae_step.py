"""The FA-VAE train step: both GAN stages, all losses, the codebook EMA and
the adaptive discriminator weight (port of favae_tpu/train/favae_step.py).

Stage 0 (generator), in the JAX step's single-body-backward design:

1. one forward of the generator with a graph: encode -> quantize (EMA) ->
   decode, taps blurred;
2. each loss head takes its gradient at a detached leaf of its input with
   `torch.autograd.grad`: L1 + LPIPS and hinge-G through the train-mode
   discriminator (which updates the BatchNorm running statistics) at
   x_recon, image FFL at x_recon, DSL / SL at the taps;
3. the adaptive weight weight_d = ||dL_rec/dW|| / (||dL_gan/dW|| + 1e-4),
   clamped to [0, 1e4], W the decoder's final conv: both weight gradients
   are `conv2d_weight(h_pre, W.shape, head gradient)`, since h_pre does not
   depend on W (reference: train_favae.py:32-39);
4. one `torch.autograd.backward` over [x_recon, taps, loss_q] with the
   combined cotangents, then the generator's Adam step.

Stage 1 (discriminator, when on): a no-grad train-mode recompute with the
updated generator (a second codebook EMA, as the reference's stage-1 forward
under model.train()), then hinge-D over D(x) and D(recon), in that order for
the BatchNorm statistics, and the discriminator's Adam step. With the
discriminator off, stage 0 still runs D(x_recon) in train mode for the
running statistics.

The epoch gates (disc_on, ffl_on) pick one of four step functions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from favae_tpu_torch.config import LossConfig, TrainConfig, VQGANConfig
from favae_tpu_torch.ops.ffl import feature_tap_ffl, focal_frequency_loss
from favae_tpu_torch.ops.gaussian import gaussian_blur_nhwc
from favae_tpu_torch.ops.losses import hinge_d_loss, hinge_g_loss
from favae_tpu_torch.train.favae_state import FavaeTrainState

Metrics = Dict[str, torch.Tensor]


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [-1, 1] images -> f32 [-1, 1], with the
    reference transform's op sequence for uint8."""
    if x.dtype == torch.uint8:
        return (x.float() / 255.0 - 0.5) / 0.5
    return x.float()


def final_conv_weight_grad(h_pre: torch.Tensor, weight: torch.Tensor,
                           grad_out: torch.Tensor) -> torch.Tensor:
    """dLoss/dW of the decoder's final 3x3 conv from its input h_pre and the
    gradient at its output (both NHWC), in h_pre's dtype, returned f32."""
    g = torch.nn.grad.conv2d_weight(
        h_pre.permute(0, 3, 1, 2), weight.shape,
        grad_out.to(h_pre.dtype).permute(0, 3, 1, 2), padding=1)
    return g.float()


def codebook_telemetry(indices: torch.Tensor, k: int) -> Metrics:
    """Batch code usage (%) and perplexity of the stage-0 assignments
    (favae_tpu/train/favae_step.py:146-166)."""
    flat = indices.reshape(-1)
    bins = torch.zeros(k, dtype=torch.float32, device=flat.device)
    bins.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    p = bins / torch.clamp(bins.sum(), min=1.0)
    pos = p > 0
    ent = torch.where(pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0)
    return {"cb_batch_usage_pct": 100.0 * pos.float().mean(),
            "cb_perplexity": torch.exp(-ent.sum())}


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def make_train_step(model_cfg: VQGANConfig, loss_cfg: LossConfig,
                    train_cfg: TrainConfig, *, disc_on: bool, ffl_on: bool
                    ) -> Callable[[FavaeTrainState, torch.Tensor],
                                  Tuple[FavaeTrainState, Metrics]]:
    """The train step for one (disc_on, ffl_on) gate combination:
    step(state, x NHWC) -> (state, metrics), the state updated in place and
    the metrics 0-d tensors (no host sync) plus `x_recon`."""
    pw = loss_cfg.perceptual_weight
    cw = loss_cfg.codebook_weight
    dw = loss_cfg.disc_weight
    spectral = loss_cfg.spectral_dtype
    k_codes = model_cfg.quantizer.codebook_size

    def train_step(state: FavaeTrainState, x: torch.Tensor):
        model, lpips = state.model, state.lpips
        model.train()
        x = to_unit_range(x)
        with torch.no_grad():
            fx_n = lpips.features(x)

        # 1. generator forward with a graph
        outs = model.generate(x, model.codebook_state(), train=True)
        x_recon0, loss_q, h_pre = outs["x_recon"], outs["loss_q"], outs["h_pre"]
        enc_feats, dec_feats = outs["enc_feats"], outs["dec_feats"]
        with torch.no_grad():
            m: Metrics = {"loss_q": loss_q.detach(),
                          **codebook_telemetry(outs["indices"], k_codes)}

        # 2. heads at detached leaves
        xr = _leaf(x_recon0)
        loss_l1 = torch.mean(torch.abs(x - xr))
        loss_perceptual = torch.mean(lpips.dist(fx_n, xr))
        loss_recon = loss_l1 + pw * loss_perceptual
        (d_recon,) = torch.autograd.grad(loss_recon, xr)
        m.update(loss_l1=loss_l1.detach(),
                 loss_perceptual=loss_perceptual.detach(),
                 loss_recon=loss_recon.detach())
        loss_g = loss_recon.detach() + cw * loss_q.detach()
        ct_xr = d_recon

        if disc_on:
            loss_disc = hinge_g_loss(model.discriminate(xr))
            (d_disc,) = torch.autograd.grad(loss_disc, xr)
            # 3. adaptive weight from the final conv's two weight gradients
            w = model.decoder.final[2].weight
            h = h_pre.detach()
            g_recon = final_conv_weight_grad(h, w, d_recon)
            g_disc = final_conv_weight_grad(h, w, d_disc)
            weight_d = torch.clamp(
                torch.linalg.vector_norm(g_recon)
                / (torch.linalg.vector_norm(g_disc) + 1e-4), 0.0, 1e4)
            loss_disc = loss_disc.detach()
            loss_g = loss_g + weight_d * dw * loss_disc
            ct_xr = ct_xr + weight_d * dw * d_disc
            m.update(loss_disc=loss_disc, weight_d=weight_d)
        else:
            with torch.no_grad():  # BatchNorm running statistics only
                model.discriminate(x_recon0.detach())
            zero = torch.zeros((), device=x.device)
            m.update(loss_disc=zero, weight_d=zero)

        ct_taps: List = [None] * (len(enc_feats) + len(dec_feats))
        if ffl_on:
            if loss_cfg.ffl_weight > 0:
                loss_ffl = focal_frequency_loss(
                    xr, x, loss_weight=loss_cfg.ffl_weight,
                    alpha=loss_cfg.ffl_alpha, compute_dtype=spectral)
                (d_ffl,) = torch.autograd.grad(loss_ffl, xr)
                loss_g = loss_g + loss_ffl.detach()
                ct_xr = ct_xr + d_ffl
                m["loss_ffl"] = loss_ffl.detach()
            taps = [_leaf(t) for t in (*enc_feats, *dec_feats)]
            n_enc = len(enc_feats)
            tap_losses = []
            if loss_cfg.dsl_weight > 0:
                loss_dsl, per_tap = feature_tap_ffl(
                    taps[:n_enc], taps[n_enc:], loss_weight=loss_cfg.dsl_weight,
                    alpha=loss_cfg.ffl_alpha, compute_dtype=spectral)
                tap_losses.append(loss_dsl)
                m["loss_dsl_features"] = loss_dsl.detach()
                for i, t in enumerate(per_tap):
                    m[f"loss_dsl_block{i + 1}"] = t.detach()
            if loss_cfg.sl_weight > 0:
                # fixed-sigma Spectrum Loss on the raw taps, mirror-paired
                # (favae_tpu/train/favae_step.py:256-284)
                sig = torch.tensor(loss_cfg.gaussian_sigma, device=x.device)
                blur = [gaussian_blur_nhwc(t, loss_cfg.gaussian_kernel, sig)
                        for t in taps]
                loss_sl, _ = feature_tap_ffl(
                    blur[:n_enc], blur[n_enc:], loss_weight=loss_cfg.sl_weight,
                    alpha=loss_cfg.ffl_alpha, compute_dtype=spectral)
                tap_losses.append(loss_sl)
                m["loss_sl_gauss_features"] = loss_sl.detach()
            if tap_losses:
                total = sum(tap_losses)
                ct_taps = list(torch.autograd.grad(total, taps))
                loss_g = loss_g + total.detach()
        m["loss_g"] = loss_g

        # 4. one backward through the generator, then Adam
        roots = [x_recon0, loss_q]
        cts = [ct_xr.to(x_recon0.dtype),
               torch.tensor(cw, dtype=loss_q.dtype, device=x.device)]
        for t, ct in zip((*enc_feats, *dec_feats), ct_taps):
            if ct is not None:
                roots.append(t)
                cts.append(ct)
        state.opt_g.zero_grad(set_to_none=True)
        torch.autograd.backward(roots, cts)
        state.opt_g.step()
        model.quantizer.set_state(outs["cb_state"])
        del outs, roots, cts

        # stage 1: the discriminator
        if disc_on:
            if train_cfg.faithful_stage1_recompute:
                with torch.no_grad():
                    out1 = model.generate(x, model.codebook_state(),
                                          train=True, inference=True)
                x_recon1 = out1["x_recon"]
                model.quantizer.set_state(out1["cb_state"])
            else:
                x_recon1 = x_recon0.detach()
            logits_real = model.discriminate(x)
            logits_fake = model.discriminate(x_recon1)
            loss_d = hinge_d_loss(logits_real, logits_fake)
            state.opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            state.opt_d.step()
            m["loss_d"] = loss_d.detach()
        else:
            m["loss_d"] = torch.zeros((), device=x.device)

        state.step += 1
        m["x_recon"] = x_recon0.detach()
        return state, m

    return train_step


def make_eval_step(loss_cfg: LossConfig
                   ) -> Callable[[FavaeTrainState, torch.Tensor], Metrics]:
    """Validation forward (favae_tpu/train/favae_step.py:346-368): L1 +
    LPIPS on eval-mode reconstructions, no tap blur, no EMA."""

    def eval_step(state: FavaeTrainState, x: torch.Tensor) -> Metrics:
        state.model.eval()
        with torch.inference_mode():
            x = to_unit_range(x)
            x_recon, indices = state.model.reconstruct(x)
            loss_l1 = torch.mean(torch.abs(x - x_recon))
            loss_perceptual = torch.mean(state.lpips(x, x_recon))
            loss_recon = loss_l1 + loss_cfg.perceptual_weight * loss_perceptual
        return dict(loss_l1=loss_l1, loss_perceptual=loss_perceptual,
                    loss_recon=loss_recon, x_recon=x_recon, indices=indices)

    return eval_step
