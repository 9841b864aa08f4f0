"""FA-VAE trainer: epoch loop with the (disc_on, ffl_on) gates, validation
and an optional profiler window (port of favae_tpu/train/favae_trainer.py).

Metrics stay on the device during an epoch and are fetched once at its end,
plus on logging steps. Step times come from CUDA events recorded at each
step's start on the card (host clock on the CPU), so timing adds no sync.
Checkpointing and resume, and the first-batch data-dependent inits
(k-means codebook, ActNorm), are not yet ported: the trainer saves nothing
and raises for those options.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import LossConfig, TrainConfig, VQGANConfig
from favae_tpu_torch.models.quantizer import check_ported
from favae_tpu_torch.profiling import ProfileWindow, StepClock
from favae_tpu_torch.train.favae_state import FavaeTrainState
from favae_tpu_torch.train.favae_step import make_eval_step, make_train_step


class FavaeTrainer:
    def __init__(self, model_cfg: VQGANConfig, loss_cfg: LossConfig,
                 train_cfg: TrainConfig, save_dir: str, device=None,
                 lpips_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 enable_profiler: bool = False):
        check_ported(model_cfg.quantizer)
        dc = model_cfg.discriminator
        if dc.kind == "patch" and dc.use_actnorm:
            raise NotImplementedError(
                "ActNorm's data-dependent init is not yet ported to "
                "favae_tpu_torch")
        self.model_cfg, self.loss_cfg, self.train_cfg = (model_cfg, loss_cfg,
                                                         train_cfg)
        self.save_dir = save_dir
        self.enable_profiler = enable_profiler
        self.device = resolve_device(device)
        # lr = base_lr * batch * devices (reference: train_favae.py:250-251)
        self.lr = train_cfg.base_lr * train_cfg.batch_size
        self.state = FavaeTrainState.create(
            model_cfg, loss_cfg, train_cfg, self.lr, self.device,
            lpips_state_dict=lpips_state_dict)
        self._steps = {(d, f): make_train_step(model_cfg, loss_cfg, train_cfg,
                                               disc_on=d, ffl_on=f)
                       for d in (False, True) for f in (False, True)}
        self.eval_step = make_eval_step(loss_cfg)
        self.start_epoch = 0
        self.history: List[Dict[str, float]] = []  # one entry per step
        self.val: List[Dict[str, float]] = []      # one entry per epoch
        self.profile: Optional[Dict] = None

    def resume(self, path: Optional[str] = None):
        raise NotImplementedError(
            "checkpoint and resume are not yet ported to favae_tpu_torch")

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # ------------------------------------------------------------------
    def train_epoch(self, loader, epoch: int) -> None:
        cfg = self.train_cfg
        disc_on = epoch >= self.loss_cfg.disc_start_epochs
        ffl_on = epoch >= self.loss_cfg.ffl_start_epochs
        step_fn = self._steps[(disc_on, ffl_on)]
        window = (ProfileWindow(self.device, self.save_dir)
                  if self.enable_profiler and epoch == self.start_epoch
                  else None)
        loader.set_epoch(epoch)
        clock = StepClock(self.device)
        pending: List[Dict[str, torch.Tensor]] = []
        for step, x in enumerate(loader):
            if window is not None:
                window.at_step(step)
            clock.mark()
            self.state, m = step_fn(self.state, self._to_device(x))
            pending.append({k: v for k, v in m.items() if v.dim() == 0})
            if step % cfg.print_steps == 0:
                print(f"epoch {epoch} step {step} " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in sorted(m.items())
                    if v.dim() == 0 and (k.startswith("loss")
                                         or k == "weight_d")), flush=True)
        clock.mark()
        if window is not None:
            window.close(len(pending))
            self.profile = window.summary or self.profile
        step_ms = clock.intervals_ms()
        for i, scalars in enumerate(pending):
            row = {k: float(v) for k, v in zip(
                scalars, torch.stack(list(scalars.values())).tolist())}
            row.update(epoch=epoch, step=i, disc_on=disc_on, ffl_on=ffl_on,
                       step_ms=step_ms[i])
            self.history.append(row)
        self._log_sigmas(self.history[-1] if self.history else {})

    def _log_sigmas(self, row: Dict[str, float]) -> None:
        """The learned DSL sigmas (reference: train_favae.py:129-147)."""
        model = self.state.model
        named = [("sigma", getattr(model, "sigmas", None)),
                 ("enc_sigma", getattr(model.encoder, "sigmas", None)),
                 ("dec_sigma", getattr(model.decoder, "sigmas", None))]
        for prefix, s in named:
            if s is not None:
                for i, v in enumerate(s.detach().cpu().tolist()):
                    row[f"{prefix}_{i}"] = v

    # ------------------------------------------------------------------
    def validate(self, loader, epoch: int) -> float:
        """L1 + LPIPS over the val set (reference: train_favae.py:180-231),
        summed on the device and fetched once."""
        keys = ("loss_l1", "loss_perceptual", "loss_recon")
        totals = torch.zeros(len(keys), device=self.device)
        n = 0
        for x in loader:
            out = self.eval_step(self.state, self._to_device(x))
            totals += torch.stack([out[k] for k in keys]) * x.shape[0]
            n += x.shape[0]
        row = dict(zip(keys, (totals / max(n, 1)).tolist()))
        row.update(epoch=epoch, images=n)
        self.val.append(row)
        print(f"=== validate epoch {epoch}: " + " ".join(
            f"{k}={row[k]:.4f}" for k in keys), flush=True)
        return row["loss_recon"]

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader, epochs: Optional[int] = None):
        epochs = epochs or self.train_cfg.epochs
        print("checkpoints are not yet ported to favae_tpu_torch: this run "
              "saves no weights", flush=True)
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(train_loader, epoch)
            if val_loader is not None:
                self.validate(val_loader, epoch)
