"""CAT trainer: the epoch loop with the fractional cosine-warmup lr,
validation CE and the cached-latent path (port of
favae_tpu/train/cat_trainer.py; reference: cat_scripts/train_cat.py:
69-244).

lr = base_lr * batch_size * world, `batch_size` a rank's share of the
global batch (1 process: world 1), as the JAX trainer counts every device
(favae_tpu/train/cat_trainer.py:55-61). The GPT trains with the frozen
FA-VAE and CLIP towers either run inside every step (the full pipeline) or
run once before training (`cache_latents`, `data/latent_cache.py`), after
which a loader over the cache with the same seed replays the image
loader's batches. Dropout and conditioning dropout draw from one
`torch.Generator` on the card, seeded `seed + 1`; its state is saved
with the checkpoint, so a resumed run draws the masks the uninterrupted
one would (JAX folds the step into a fixed key instead). Losses stay on
the device during an epoch and are fetched once at its end (and on print
steps), with step times from CUDA events at each step's start (host clock
on the CPU). Each epoch ends with `CheckpointManager.on_epoch_end`: the
GPT, its AdamW moments, the step and the generator; the frozen towers
come from their own files. Sample previews on `img_steps` and after
validation draw from a generator of their own, seeded from `seed` and the
step, so turning them on leaves the training trajectory as it was.

With a `mesh` (`parallel.mesh.make_mesh`) the ranks form a `(dp, tp)`
grid: the GPT's weights split over tp (`parallel.sharding.shard_gpt_`),
the frozen towers replicated, each dp group's loader shard holding
`batch_size * tp` samples a step that its tp ranks share. The gradients
are averaged over dp; the dropout generator is seeded from (seed, dp
rank), so the masks are equal within a tp group, where they act on
replicated activations. Checkpoints hold gathered full tensors (the file
of a tp=1 run, plus every dp rank's generator state), written by rank 0;
a run resumes at another tp. Validation is the global mean; previews
are sampled by dp rank 0's tp group through the split blocks and written
by rank 0.
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
from favae_tpu_torch.parallel.mesh import (all_reduce_sum, assert_replicated,
                                           is_main_process, world_group)
from favae_tpu_torch.parallel.sharding import (gather_gpt_state,
                                               shard_gpt_, shard_gpt_state)
from favae_tpu_torch.profiling import ProfileWindow, StepClock
from favae_tpu_torch.train.cat_step import (CATAdamW, CATTrainState,
                                            cat_eval_step,
                                            cat_latent_eval_step,
                                            make_cat_latent_train_step,
                                            make_cat_train_step)
from favae_tpu_torch.train.schedule import make_step_schedule
from favae_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              restore_checkpoint)
from favae_tpu_torch.utils.logging import MetricWriter, print0


class CATTrainer:
    def __init__(self, cfg: CATConfig, save_dir: str, steps_per_epoch: int,
                 batch_size: int, device=None, tokenizer=None,
                 enabled_warmup: bool = True, seed: int = 0,
                 grad_accum: int = 1, cache_latents: bool = False,
                 cat: Optional[CATModel] = None,
                 log_dir: Optional[str] = None, save_every_epoch: int = 1,
                 enable_profiler: bool = False, mesh=None):
        """`cat` replaces the seeded random CATModel that `build_cat` would
        make (for weights loaded by the caller); `enable_profiler` profiles
        steps [2, 5) of the first epoch (`profiling.ProfileWindow`)."""
        self.cfg, self.save_dir = cfg, save_dir
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dp = mesh.dp if mesh is not None else None
        self.tp = mesh.tp if mesh is not None else None
        world = mesh.world if mesh is not None else 1
        main = is_main_process()
        self.lr = cfg.base_lr * batch_size * world
        self.lr_schedule = make_step_schedule(
            steps_per_epoch, warmup_epochs=cfg.warmup_epochs,
            epochs=cfg.epochs, lr=self.lr, min_lr=cfg.min_lr,
            enabled=enabled_warmup)
        self.cat = cat or build_cat(cfg, self.device, seed=seed,
                                    tokenizer=tokenizer)
        if mesh is not None:
            assert_replicated(list(self.cat.gpt.parameters())
                              + list(self.cat.favae.parameters())
                              + list(self.cat.clip.parameters()),
                              world_group(), "the CAT weights")
            shard_gpt_(self.cat.gpt, self.tp)
        self.state = CATTrainState(cat=self.cat,
                                   opt=CATAdamW(self.cat.gpt, cfg),
                                   lr_schedule=self.lr_schedule)
        self.cache_latents = cache_latents
        if cache_latents:
            self.train_step = make_cat_latent_train_step(grad_accum, self.dp)
            self.eval_step = cat_latent_eval_step
        else:
            self.train_step = make_cat_train_step(grad_accum, self.dp)
            self.eval_step = cat_eval_step
        self.seed = seed
        dp_rank = self.dp.rank if self.dp is not None else 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            (dp_rank << 32) + seed + 1)
        self.ckpt = CheckpointManager(save_dir, save_every_epoch,
                                      device=self.device)
        self.writer = MetricWriter(log_dir if main else None)
        self.enable_profiler = enable_profiler and main
        self.profile: Optional[Dict] = None
        self.start_epoch = 0
        self.precompute_s = 0.0  # host seconds of the latent precompute
        self.history: List[Dict[str, float]] = []  # one entry per step
        self.val: List[Dict[str, float]] = []      # one entry per epoch

    def resume(self, path: Optional[str] = None):
        """Resume or warm-start (reference: cat_scripts/train_cat.py:
        199-204). ``path=None`` restores ``save_dir/latest`` (nothing
        happens without one); a checkpoint directory restores the GPT, its
        AdamW, the step and the dropout generator from there, with the
        epoch and best score of its metadata; a reference-format `.pt`
        (`CelebA_CAT.pt`, or the state_dict) warm-starts the GPT with a
        fresh optimizer (its full weights cut to this rank's slices under
        tp)."""
        if path is None:
            sd, meta = self.ckpt.try_resume()
            if sd is not None:
                self.load_state_dict(sd)
                self.start_epoch = int(meta.get("epoch", 0))
                print0(f"resumed CAT from epoch {self.start_epoch}")
            return
        if os.path.isfile(path):
            from favae_tpu_torch.convert import load_reference_gpt
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("transformer_model", sd)
            load_reference_gpt(self.cat.gpt, shard_gpt_state(sd, self.tp))
            self.state = CATTrainState(cat=self.cat,
                                       opt=CATAdamW(self.cat.gpt, self.cfg),
                                       lr_schedule=self.lr_schedule)
            print0(f"warm-started GPT weights from {path}")
            return
        sd, meta = restore_checkpoint(path, self.device)
        self.load_state_dict(sd)
        self.start_epoch = int(meta.get("epoch", 0))
        self.ckpt.best_score = meta.get("best_score", float("inf"))
        print0(f"resumed CAT from {path} at epoch {self.start_epoch}")

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the GPT, its AdamW, the step and the
        dropout generator's state; under a mesh the GPT and the moments
        gathered to full tensors over tp (every rank takes part), and
        `dp_generators` every dp rank's generator state."""
        opt = self.state.opt.state_dict()
        names = self.state.opt.names
        for k in ("mu", "nu"):
            full = gather_gpt_state(dict(zip(names, opt[k])), self.tp)
            opt[k] = [full[n] for n in names]
        sd = {"gpt": gather_gpt_state(self.cat.gpt.state_dict(), self.tp),
              "opt": opt, "step": self.state.step,
              "generator": self.generator.get_state()}
        if self.dp is not None and self.dp.size > 1:
            states = [None] * self.dp.size
            torch.distributed.all_gather_object(
                states, self.generator.get_state(), group=self.dp.group)
            sd["generator"], sd["dp_generators"] = states[0], states
        return sd

    def load_state_dict(self, sd: Dict) -> None:
        """Restore a `state_dict` of a run at any tp: full tensors are cut
        to this rank's slices. A dp rank other than 0 takes its own saved
        generator state where the checkpoint has one for it and keeps its
        seeded one otherwise."""
        self.cat.gpt.load_state_dict(shard_gpt_state(sd["gpt"], self.tp),
                                     strict=True)
        names = self.state.opt.names
        opt = dict(sd["opt"])
        for k in ("mu", "nu"):
            part = shard_gpt_state(dict(zip(names, opt[k])), self.tp)
            opt[k] = [part[n] for n in names]
        self.state.opt.load_state_dict(opt)
        self.state.step = int(sd["step"])
        dp_rank = self.dp.rank if self.dp is not None else 0
        states = sd.get("dp_generators") or [sd["generator"]]
        if dp_rank < len(states):
            self.generator.set_state(states[dp_rank].cpu())

    def _args(self, batch):
        """The step's tensors on the device: (x, text ids) on the full
        pipeline, (z, embeds, mask) on the cached one."""
        if self.cache_latents:
            z, embeds, mask, _ids, _caps = batch
            return tuple(torch.from_numpy(a).to(self.device)
                         for a in (z, embeds, mask))
        # (images, [CLIP images], captions): no step reads the CLIP view
        # (favae_tpu/train/cat_trainer.py, _prep_batch)
        x, captions = batch[0], batch[-1]
        return (torch.from_numpy(x).to(self.device),
                self.cat.tokenize(list(captions)))

    def latent_loader(self, loader: DataLoader) -> DataLoader:
        """Precompute the frozen towers' outputs over `loader`'s dataset and
        wrap them in a loader with the same batch size, shuffle, seed and
        shard (the cache covers the whole dataset on every rank, as the
        JAX trainer's does)."""
        t0 = time.perf_counter()
        ds = precompute_latents(self.cat, loader.ds, loader.batch_size,
                                num_workers=loader.num_workers,
                                log=lambda m: print(m, flush=True))
        self.precompute_s += time.perf_counter() - t0
        return DataLoader(ds, loader.batch_size,
                          num_workers=loader.num_workers,
                          shuffle=loader.shuffle, seed=loader.seed,
                          drop_last=loader.drop_last,
                          shard_index=loader.shard_index,
                          shard_count=loader.shard_count)

    def train_epoch(self, loader, epoch: int, print_steps: int = 10,
                    img_steps: int = 1000) -> None:
        window = (ProfileWindow(self.device, self.save_dir)
                  if self.enable_profiler and epoch == self.start_epoch
                  else None)
        loader.set_epoch(epoch)
        steps_per_epoch = len(loader)
        clock = StepClock(self.device)
        losses: List[torch.Tensor] = []
        first = self.state.step
        t_last, seen = time.perf_counter(), 0
        for step, batch in enumerate(loader):
            if window is not None:
                window.at_step(step)
            clock.mark()
            args = self._args(batch)
            self.state, m = self.train_step(self.state, *args,
                                            self.generator)
            losses.append(m["loss_gpt"])
            seen += args[0].shape[0] * (self.dp.size if self.dp else 1)
            gstep = epoch * steps_per_epoch + step
            if step % print_steps == 0:
                now = time.perf_counter()
                scalars = {"loss_gpt": float(m["loss_gpt"]),
                           "lr": self.lr_schedule(self.state.step - 1),
                           "samples_per_sec": seen / max(now - t_last, 1e-9)}
                t_last, seen = now, 0
                self.writer.scalars("train", scalars, gstep)
                print0(f"epoch {epoch} step {step} loss_gpt="
                       f"{scalars['loss_gpt']:.4f} lr={scalars['lr']:.3e} "
                       f"samples/s={scalars['samples_per_sec']:.2f}")
            if img_steps and gstep % img_steps == 0:
                self._log_samples("train/from-cond", batch, args, gstep)
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

    def _log_samples(self, name: str, batch, args, step: int, n: int = 4):
        """A preview: the first `n` captions of a batch sampled to images
        beside the batch's images (on the cached path the FA-VAE decode of
        its cached tokens, which stand for the images there), from a
        generator seeded from `seed` and `step` (JAX folds the step into
        its key), never the training one. Under a mesh dp rank 0's tp group
        samples (through the split blocks) and rank 0 writes. The GPT keeps
        no serving plan after it (`CATModel.drop_plans`)."""
        if self.dp is not None and self.dp.rank != 0:
            return
        if self.cache_latents:
            g = self.cfg.gpt.image_encoded_dim
            gt = self.cat.decode_to_img(args[0][:n].reshape(-1, g, g))
            text_ids = torch.from_numpy(batch[3][:n]).long().to(self.device)
            captions = batch[4]
        else:
            gt, captions = batch[0][:n], batch[1]
            text_ids = args[1][:n]
        gen = torch.Generator(device=self.device).manual_seed(
            ((self.seed + 1) << 32) + step)
        imgs, _ = self.cat.sample_images(text_ids, generator=gen,
                                         top_k=self.cfg.top_k,
                                         top_p=self.cfg.top_p)
        self.cat.drop_plans()
        self.writer.caption_grid(name, gt, imgs, list(captions[:n]), step)

    @torch.no_grad()
    def validate(self, loader, epoch: int) -> float:
        """Mean CE over the val set, summed on the device, fetched once;
        then a preview of the last batch."""
        total = torch.zeros((), device=self.device)
        n = 0
        last = None
        for batch in loader:
            args = self._args(batch)
            m = self.eval_step(self.state, *args)
            total += m["loss_gpt"] * args[0].shape[0]
            n += args[0].shape[0]
            last = (batch, args)
        if self.dp is not None:  # the global mean: sums and counts
            both = all_reduce_sum(torch.stack([total, total.new_tensor(
                float(n))]), self.dp)
            total, n = both[0], int(both[1].item())
        val = total.item() / max(n, 1)
        self.val.append({"epoch": epoch, "loss_gpt": val, "samples": n})
        self.writer.scalars("val", {"loss_gpt": val}, epoch)
        if last is not None:
            self._log_samples("val/from-cond", *last, epoch)
        print0(f"=== validate CAT epoch {epoch}: loss_gpt={val:.4f}")
        return val

    def fit(self, train_loader, val_loader, epochs: Optional[int] = None,
            print_steps: int = 10, img_steps: int = 1000) -> None:
        """Train from `start_epoch` to `epochs`, validating (where the val
        loader has a batch: an empty one scores inf, as in the JAX package)
        and checkpointing after each epoch; a preview every
        `img_steps` global steps (none with 0) and after each
        validation."""
        epochs = epochs or self.cfg.epochs
        if self.cache_latents:
            train_loader = self.latent_loader(train_loader)
            if val_loader:
                val_loader = self.latent_loader(val_loader)
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(train_loader, epoch, print_steps, img_steps)
            score = (self.validate(val_loader, epoch) if val_loader
                     else float("inf"))
            last = epoch == epochs - 1
            if self.ckpt.due(epoch, last):  # a gather under tp
                self.ckpt.on_epoch_end(epoch, score, self.state_dict(), last)
        self.writer.close()
