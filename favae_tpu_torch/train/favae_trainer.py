"""FA-VAE trainer: epoch loop with the (disc_on, ffl_on) gates, validation,
checkpoints, logging and an optional profiler window (port of
favae_tpu/train/favae_trainer.py).

Metrics stay on the device during an epoch and are fetched once at its end,
plus on logging steps (`print_steps`), which also write the train scalars;
a recon grid on `img_steps` is fetched only when a writer records it. Step
times come from CUDA events recorded at each step's start on the card (host
clock on the CPU), so timing adds no sync. Each epoch ends with
`CheckpointManager.on_epoch_end` (latest, and best on improvement); `resume`
restores a run. Before the first epoch of a fresh run, `fit` runs the
first-batch data-dependent inits: the k-means codebook and ActNorm. The
state's generator, seeded from the config and kept in the checkpoints,
draws k-means' first permutation and the steps' quantizer draws.

With a `mesh` (`parallel.mesh.make_mesh`, one process a rank under
torchrun) the trainer is data parallel as the JAX trainer's mesh is
(favae_tpu/train/favae_trainer.py:50-55): lr = base_lr * batch * world,
the loader gives each rank its shard, the step and the model reduce over
dp (`train/favae_step.py`), the parameters and buffers are checked equal
on every rank at the start, k-means runs on the gathered first global
batch, validation is the global mean, and rank 0 alone prints, logs,
profiles and writes checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import LossConfig, TrainConfig, VQGANConfig
from favae_tpu_torch.models.discriminator import actnorm_data_init_
from favae_tpu_torch.models.quantizer import CodebookState, kmeans, l2norm
from favae_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_sum,
                                           assert_replicated, attach_dp,
                                           is_main_process)
from favae_tpu_torch.profiling import ProfileWindow, StepClock
from favae_tpu_torch.train.favae_state import (FavaeTrainState,
                                               make_optimizers)
from favae_tpu_torch.train.favae_step import (make_eval_step,
                                              make_train_step, to_unit_range)
from favae_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              restore_checkpoint)
from favae_tpu_torch.utils.logging import (MetricWriter, device_memory_mib,
                                           print0)


def _host_f32(x: np.ndarray) -> np.ndarray:
    """A uint8 [0, 255] or f32 [-1, 1] host batch as f32 [-1, 1], for the
    recon grids (favae_tpu/train/favae_trainer.py:31-36)."""
    x = np.asarray(x)
    return x.astype(np.float32) / 127.5 - 1.0 if x.dtype == np.uint8 else x


class FavaeTrainer:
    def __init__(self, model_cfg: VQGANConfig, loss_cfg: LossConfig,
                 train_cfg: TrainConfig, save_dir: str, device=None,
                 lpips_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 log_dir: Optional[str] = None,
                 enable_profiler: bool = False, mesh=None):
        self.model_cfg, self.loss_cfg, self.train_cfg = (model_cfg, loss_cfg,
                                                         train_cfg)
        self.save_dir = save_dir
        main = is_main_process()
        self.enable_profiler = enable_profiler and main
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dp = mesh.dp if mesh is not None else None
        world = mesh.world if mesh is not None else 1
        # lr = base_lr * batch * devices (reference: train_favae.py:250-251)
        self.lr = train_cfg.base_lr * train_cfg.batch_size * world
        self.state = FavaeTrainState.create(
            model_cfg, loss_cfg, train_cfg, self.lr, self.device,
            lpips_state_dict=lpips_state_dict)
        if self.dp is not None:
            attach_dp(self.state.model, self.dp)
            model = self.state.model
            assert_replicated([*model.parameters(), *model.buffers()],
                              self.dp, "the FA-VAE's parameters and buffers")
        self._steps = {(d, f): make_train_step(model_cfg, loss_cfg, train_cfg,
                                               disc_on=d, ffl_on=f,
                                               dp=self.dp)
                       for d in (False, True) for f in (False, True)}
        self.eval_step = make_eval_step(loss_cfg)
        self.ckpt = CheckpointManager(save_dir, train_cfg.save_every_epoch,
                                      device=self.device)
        self.writer = MetricWriter(log_dir if main else None)
        self.start_epoch = 0
        self.history: List[Dict[str, float]] = []  # one entry per step
        self.val: List[Dict[str, float]] = []      # one entry per epoch
        self.profile: Optional[Dict] = None

    def resume(self, path: Optional[str] = None):
        """Resume or warm-start (reference: train_favae.py:334-341).

        * ``path=None``: restore ``save_dir/latest`` (with the crash-window
          fallbacks): model, both Adams and the step, epoch and best score
          from its metadata; nothing happens without one.
        * ``path`` a checkpoint directory: the same full restore from there.
        * ``path`` a reference-format ``.pt``: the model's weights, buffers
          included, with fresh optimizers and epoch 0.
        """
        if path is None:
            sd, meta = self.ckpt.try_resume()
            if sd is not None:
                self.state.load_state_dict(sd)
                self.start_epoch = int(meta.get("epoch", 0))
                print0(f"resumed from epoch {self.start_epoch}, "
                       f"best {self.ckpt.best_score:.4f}")
            return
        if os.path.isfile(path):
            from favae_tpu_torch.convert import load_reference_checkpoint
            load_reference_checkpoint(self.state.model, path)
            self.state.opt_g, self.state.opt_d = make_optimizers(
                self.state.model, self.train_cfg, self.lr)
            self.state.step = 0
            print0(f"warm-started model weights from torch checkpoint {path}")
            return
        sd, meta = restore_checkpoint(path, self.device)
        self.state.load_state_dict(sd)
        self.start_epoch = int(meta.get("epoch", 0))
        self.ckpt.best_score = meta.get("best_score", float("inf"))
        print0(f"resumed from {path} at epoch {self.start_epoch}, "
               f"best {self.ckpt.best_score:.4f}")

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # ------------------------------------------------------------------
    def _data_dependent_init(self, x0: np.ndarray,
                             first: Optional[torch.Tensor] = None) -> None:
        """The first-batch inits the reference makes lazily in its first
        training forward (favae_tpu/train/favae_trainer.py:128-200): the
        k-means codebook on the batch's codebook inputs (embed, cluster_size
        and embed_avg replaced; reference: models/l2_quantize.py:352-368),
        its first permutation `first` or one drawn from the state's
        generator, and each ActNorm's loc and scale from its input in
        D(x_recon) of an inference forward (reference:
        models/discriminator.py:67-86). Under dp, `x0` is this rank's shard
        of the first global batch: k-means runs on the gathered global
        batch (`first` a permutation of its rows) and ActNorm takes its
        statistics."""
        qcfg = self.model_cfg.quantizer
        dcfg = self.model_cfg.discriminator
        use_actnorm = dcfg.use_actnorm and dcfg.kind == "patch"
        if not (qcfg.kmeans_init or use_actnorm):
            return
        model = self.state.model
        model.eval()
        x = to_unit_range(self._to_device(np.asarray(x0)))
        if qcfg.kmeans_init:
            flat = all_gather_rows(model.codebook_inputs(x), self.dp)
            if qcfg.use_cosine_sim:
                flat = l2norm(flat)
            if first is None:
                first = torch.randperm(flat.shape[0], device=self.device,
                                       generator=self.state.generator)
            means, bins = kmeans(flat, qcfg.codebook_size, qcfg.kmeans_iters,
                                 qcfg.use_cosine_sim, first)
            model.quantizer.set_state(CodebookState(
                embed=means, cluster_size=bins, embed_avg=means))
            print0(f"k-means codebook init: {int((bins > 0).sum())}"
                   f"/{qcfg.codebook_size} bins populated")
        if use_actnorm:
            x_recon, _ = model.reconstruct(x)
            n = actnorm_data_init_(model.discriminator,
                                   x_recon.clone().permute(0, 3, 1, 2),
                                   self.dp)
            print0(f"ActNorm data-dependent init: {n} layers initialized "
                   "from the first batch")

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
        steps_per_epoch = len(loader)
        clock = StepClock(self.device)
        pending: List[Dict[str, torch.Tensor]] = []
        t_last, imgs_since = time.perf_counter(), 0
        for step, x in enumerate(loader):
            if window is not None:
                window.at_step(step)
            clock.mark()
            self.state, m = step_fn(self.state, self._to_device(x))
            pending.append({k: v for k, v in m.items() if v.dim() == 0})
            imgs_since += x.shape[0] * (self.dp.size if self.dp else 1)
            gstep = epoch * steps_per_epoch + step
            if step % cfg.print_steps == 0:
                scalars = dict(zip(pending[-1], torch.stack(
                    list(pending[-1].values())).tolist()))
                now = time.perf_counter()
                scalars["imgs_per_sec"] = imgs_since / max(now - t_last, 1e-9)
                scalars["mem_mib"] = device_memory_mib(self.device)
                t_last, imgs_since = now, 0
                self._log_sigmas(scalars)
                self.writer.scalars("train", scalars, gstep)
                print0(f"epoch {epoch} step {step} " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(scalars.items())
                    if k.startswith("loss") or k in ("weight_d",
                                                     "imgs_per_sec")))
            if step % cfg.img_steps == 0:
                self.writer.recon_grid("train/img-recon", _host_f32(x[:4]),
                                       m["x_recon"][:4], gstep)
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
        last = None
        for x in loader:
            out = self.eval_step(self.state, self._to_device(x))
            totals += torch.stack([out[k] for k in keys]) * x.shape[0]
            n += x.shape[0]
            last = (x, out["x_recon"])
        if self.dp is not None:  # the global mean: sums and counts
            both = all_reduce_sum(torch.cat([totals, totals.new_tensor(
                [float(n)])]), self.dp)
            totals, n = both[:-1], int(both[-1].item())
        row = dict(zip(keys, (totals / max(n, 1)).tolist()))
        self.writer.scalars("val", row, epoch)
        if last is not None:
            self.writer.recon_grid("val/img-recon", _host_f32(last[0][:4]),
                                   last[1][:4], epoch)
        row.update(epoch=epoch, images=n)
        self.val.append(row)
        print0(f"=== validate epoch {epoch}: " + " ".join(
            f"{k}={row[k]:.4f}" for k in keys))
        return row["loss_recon"]

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader, epochs: Optional[int] = None):
        """Train from `start_epoch` to `epochs`, after the first-batch
        inits in a fresh run, validating (where the val loader has a batch:
        an empty one scores inf, as in the JAX package) and checkpointing
        after each epoch."""
        epochs = epochs or self.train_cfg.epochs
        if self.start_epoch == 0:
            train_loader.set_epoch(0)
            first = next(iter(train_loader), None)
            if first is not None:
                self._data_dependent_init(first)
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(train_loader, epoch)
            score = (self.validate(val_loader, epoch) if val_loader
                     else float("inf"))
            self.ckpt.on_epoch_end(epoch, score, self.state.state_dict(),
                                   is_last=epoch == epochs - 1)
        self.writer.close()
