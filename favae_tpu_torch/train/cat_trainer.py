"""CAT trainer: the epoch loop with the fractional cosine-warmup lr,
validation CE and the cached-latent path (port of
favae_tpu/train/cat_trainer.py; reference: cat_scripts/train_cat.py:
69-244).

One card: lr = base_lr * batch_size. The GPT trains with the frozen
FA-VAE and CLIP towers either run inside every step (the full pipeline) or
run once before training (`cache_latents`, `data/latent_cache.py`), after
which a loader over the cache with the same seed replays the image
loader's batches. Dropout and conditioning dropout draw from one
`torch.Generator` on the card, seeded `seed + 1`. Losses stay on the
device during an epoch and are fetched once at its end, with step times
from CUDA events at each step's start (host clock on the CPU). Checkpoints
and the sample previews are not yet ported: the trainer saves nothing.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import CATConfig
from favae_tpu_torch.data.latent_cache import precompute_latents
from favae_tpu_torch.data.pipeline import DataLoader
from favae_tpu_torch.models.txt_cond import CATModel, build_cat
from favae_tpu_torch.profiling import ProfileWindow, StepClock
from favae_tpu_torch.train.cat_step import (CATAdamW, CATTrainState,
                                            cat_eval_step,
                                            cat_latent_eval_step,
                                            make_cat_latent_train_step,
                                            make_cat_train_step)
from favae_tpu_torch.train.schedule import make_step_schedule


class CATTrainer:
    def __init__(self, cfg: CATConfig, save_dir: str, steps_per_epoch: int,
                 batch_size: int, device=None, tokenizer=None,
                 enabled_warmup: bool = True, seed: int = 0,
                 grad_accum: int = 1, cache_latents: bool = False,
                 cat: Optional[CATModel] = None,
                 enable_profiler: bool = False):
        """`cat` replaces the seeded random CATModel that `build_cat` would
        make (for weights loaded by the caller); `enable_profiler` profiles
        steps [2, 5) of the first epoch (`profiling.ProfileWindow`)."""
        self.cfg, self.save_dir = cfg, save_dir
        self.device = resolve_device(device)
        self.lr = cfg.base_lr * batch_size
        self.lr_schedule = make_step_schedule(
            steps_per_epoch, warmup_epochs=cfg.warmup_epochs,
            epochs=cfg.epochs, lr=self.lr, min_lr=cfg.min_lr,
            enabled=enabled_warmup)
        self.cat = cat or build_cat(cfg, self.device, seed=seed,
                                    tokenizer=tokenizer)
        self.state = CATTrainState(cat=self.cat,
                                   opt=CATAdamW(self.cat.gpt, cfg),
                                   lr_schedule=self.lr_schedule)
        self.cache_latents = cache_latents
        if cache_latents:
            self.train_step = make_cat_latent_train_step(grad_accum)
            self.eval_step = cat_latent_eval_step
        else:
            self.train_step = make_cat_train_step(grad_accum)
            self.eval_step = cat_eval_step
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.enable_profiler = enable_profiler
        self.profile: Optional[Dict] = None
        self.start_epoch = 0
        self.precompute_s = 0.0  # host seconds of the latent precompute
        self.history: List[Dict[str, float]] = []  # one entry per step
        self.val: List[Dict[str, float]] = []      # one entry per epoch

    def resume(self, path: Optional[str] = None):
        """Warm-start the GPT from a reference-format `.pt` (`CelebA_CAT.pt`
        or the state_dict) with a fresh optimizer (reference:
        cat_scripts/train_cat.py:199-204). Resuming a run (no path, or an
        Orbax directory) is not yet ported."""
        if path is None or not os.path.isfile(path):
            raise NotImplementedError("resuming a CAT run (checkpoints) is "
                                      "not yet ported to favae_tpu_torch")
        from favae_tpu_torch.convert import load_reference_gpt
        load_reference_gpt(self.cat.gpt, path)
        self.state = CATTrainState(cat=self.cat,
                                   opt=CATAdamW(self.cat.gpt, self.cfg),
                                   lr_schedule=self.lr_schedule)
        print(f"warm-started GPT weights from {path}", flush=True)

    def _args(self, batch):
        """The step's tensors on the device: (x, text ids) on the full
        pipeline, (z, embeds, mask) on the cached one."""
        if self.cache_latents:
            z, embeds, mask, _ids, _caps = batch
            return tuple(torch.from_numpy(a).to(self.device)
                         for a in (z, embeds, mask))
        x, captions = batch
        return (torch.from_numpy(x).to(self.device),
                self.cat.tokenize(list(captions)))

    def latent_loader(self, loader: DataLoader) -> DataLoader:
        """Precompute the frozen towers' outputs over `loader`'s dataset and
        wrap them in a loader with the same batch size, shuffle and seed."""
        t0 = time.perf_counter()
        ds = precompute_latents(self.cat, loader.ds, loader.batch_size,
                                num_workers=loader.num_workers,
                                log=lambda m: print(m, flush=True))
        self.precompute_s += time.perf_counter() - t0
        return DataLoader(ds, loader.batch_size,
                          num_workers=loader.num_workers,
                          shuffle=loader.shuffle, seed=loader.seed,
                          drop_last=loader.drop_last)

    def train_epoch(self, loader, epoch: int, print_steps: int = 10) -> None:
        window = (ProfileWindow(self.device, self.save_dir)
                  if self.enable_profiler and epoch == self.start_epoch
                  else None)
        loader.set_epoch(epoch)
        clock = StepClock(self.device)
        losses: List[torch.Tensor] = []
        first = self.state.step
        for step, batch in enumerate(loader):
            if window is not None:
                window.at_step(step)
            clock.mark()
            self.state, m = self.train_step(self.state, *self._args(batch),
                                            self.generator)
            losses.append(m["loss_gpt"])
            if step % print_steps == 0:
                print(f"epoch {epoch} step {step} loss_gpt="
                      f"{float(m['loss_gpt']):.4f} lr="
                      f"{self.lr_schedule(self.state.step - 1):.3e}",
                      flush=True)
        clock.mark()
        if window is not None:
            window.close(len(losses))
            self.profile = window.summary or self.profile
        step_ms = clock.intervals_ms()
        values = torch.stack(losses).tolist() if losses else []
        for i, (loss, ms) in enumerate(zip(values, step_ms)):
            self.history.append({"epoch": epoch, "step": i, "loss_gpt": loss,
                                 "lr": self.lr_schedule(first + i),
                                 "step_ms": ms})

    @torch.no_grad()
    def validate(self, loader, epoch: int) -> float:
        """Mean CE over the val set, summed on the device, fetched once."""
        total = torch.zeros((), device=self.device)
        n = 0
        for batch in loader:
            args = self._args(batch)
            m = self.eval_step(self.state, *args)
            total += m["loss_gpt"] * args[0].shape[0]
            n += args[0].shape[0]
        val = total.item() / max(n, 1)
        self.val.append({"epoch": epoch, "loss_gpt": val, "samples": n})
        print(f"=== validate CAT epoch {epoch}: loss_gpt={val:.4f}",
              flush=True)
        return val

    def fit(self, train_loader, val_loader, epochs: Optional[int] = None,
            print_steps: int = 10) -> None:
        epochs = epochs or self.cfg.epochs
        print("checkpoints are not yet ported to favae_tpu_torch: this run "
              "saves no weights", flush=True)
        if self.cache_latents:
            train_loader = self.latent_loader(train_loader)
            if val_loader is not None:
                val_loader = self.latent_loader(val_loader)
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(train_loader, epoch, print_steps)
            if val_loader is not None:
                self.validate(val_loader, epoch)
