"""Driver `cat_train`: CAT training through `CATTrainer.train_epoch` as
`cli/train_cat.py` builds the trainer (AdamW, dropout and conditioning
dropout from the trainer's generator, no warm-up: the CLI's default), fed
by the port's `DataLoader` over a `PklImageDataset` manifest of the seed's
JPEG files and captions; with `cached` the trainer's latent cache
(`data/latent_cache.py`) is filled from them in set-up and the steps read
it, bypassing the frozen FA-VAE and CLIP towers.

Set-up drives the trainer through its first steps with the window's own
call and feed (`first_steps`), keeping each step's loss, the first gradient
as AdamW got it and the GPT's change after them; then `warmup_steps` more.
The check (the port freed) works the inputs out again with the reference:
the files decoded and encoded by the reference FA-VAE, the captions
tokenized and encoded by the reference CLIP tower, all float32; its GPT
takes the same steps from the same weights with the dropout draws of a
generator seeded as the trainer's; the numbers are as for `favae_train`.

Traffic parameters: images, image_size, batch, loader_threads, cached,
first_steps, warmup_steps, print_steps, img_steps, trace_seconds, limits.
"""

from __future__ import annotations

import gc
import json
import sys

import torch

from benchmark import cat, data, favae
from benchmark.feed import Feed
from benchmark.harness import Check, Window

MERGES = ["s y", "sy n", "syn t"]  # cli/train_cat.py's synthetic merges


class State:
    pass


def _mu_grads(opt) -> dict:
    """The first gradient as AdamW got it: mu = (1 - b1) g after one step."""
    return {n: m.float() / (1.0 - opt.b1) for n, m in zip(opt.names, opt.mu)}


def setup(ctx):
    from favae_tpu_torch import config as PC
    from favae_tpu_torch.data.pipeline import DataLoader, PklImageDataset
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu_torch.models.txt_cond import build_cat
    from favae_tpu_torch.train.cat_trainer import CATTrainer

    tr = ctx.cell.traffic
    st = State()
    dev = ctx.device
    st.seed = ctx.seed
    st.lseed = favae.loader_seed(ctx.seed)
    cfg = cat.cat_config(PC, ctx.cell.config)
    st.manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                       tr["images"], tr["image_size"], dev,
                                       with_captions=True)
    model = build_cat(cfg, dev, seed=0,
                      tokenizer=BPETokenizer(merges=MERGES))
    vq_sd, clip_sd, gpt_sd = cat.make_weights(ctx.cell.config, ctx.seed, dev)
    model.favae.load_state_dict(vq_sd)
    model.clip.load_state_dict(clip_sd)
    model.gpt.load_state_dict(gpt_sd)
    del vq_sd, clip_sd, gpt_sd
    st.batch = tr["batch"]
    res = cfg.vqgan.codec.resolution
    loader = DataLoader(
        PklImageDataset(str(st.manifest), res, with_captions=True),
        st.batch, num_workers=tr["loader_threads"], shuffle=True,
        seed=st.lseed)
    trainer = CATTrainer(cfg, str(ctx.workdir / "cat"),
                         steps_per_epoch=len(loader), batch_size=st.batch,
                         device=dev, enabled_warmup=False, seed=st.lseed,
                         cache_latents=tr["cached"], cat=model,
                         log_dir=str(ctx.workdir / "cat" / "runs"))
    if tr["cached"]:
        loader = trainer.latent_loader(loader)
    st.feed = Feed(loader, ctx)
    kw = dict(print_steps=tr["print_steps"], img_steps=tr["img_steps"])
    start = {n: p.detach().clone() for n, p in model.gpt.named_parameters()}
    trainer.train_epoch(st.feed.take(1), 0, **kw)
    st.grads = favae.norms(_mu_grads(trainer.state.opt))
    trainer.train_epoch(st.feed.take(tr["first_steps"] - 1), 0, **kw)
    st.changes = favae.changes(model.gpt, start)
    del start
    st.losses = [{"loss_gpt": h["loss_gpt"]} for h in trainer.history]
    st.first = list(st.feed.served)
    trainer.train_epoch(st.feed.take(tr["warmup_steps"]), 0, **kw)
    st.trainer, st.kw = trainer, kw
    return st


def window(st, ctx) -> Window:
    batches = st.feed.until_deadline()
    t0 = ctx.open_window()
    st.trainer.train_epoch(batches, 1, **st.kw)
    t1 = ctx.close_window()
    n = batches.count
    return Window(t0, t1, n, {"train_samples_per_s": n * st.batch / (t1 - t0)},
                  extra={"work_span": "step", "samples_per_step": st.batch})


def reference_steps(ctx, seed: int, manifest, served, fp8: bool = False,
                    rows: slice = slice(None)):
    """The reference's losses, first gradients and changes (tensors) over
    the batches `served` ((epoch, batch) of the loader's order), the inputs
    worked out from the files and captions; `fp8` the control's precision,
    `rows` a fault's cut of each batch."""
    from benchmark.reference.cat_train import adamw, gpt_loss
    from benchmark.reference.clip_text import BPETokenizer, tokenize
    from benchmark.reference.schedule import make_step_schedule
    tr = ctx.cell.traffic
    dev = ctx.device
    cfg, vq, clip, gpt = cat.reference(ctx.cell.config, seed, dev, fp8=fp8)
    tok = BPETokenizer(merges=MERGES)
    entries = data.read_manifest(manifest)
    b, n = tr["batch"], len(entries)
    lseed = favae.loader_seed(seed)
    sched = make_step_schedule(n // b, warmup_epochs=cfg.warmup_epochs,
                               epochs=cfg.epochs, lr=cfg.base_lr * b,
                               min_lr=cfg.min_lr, enabled=False)
    gpt.train()
    opt = adamw(gpt, cfg)
    start = {k: p.detach().clone() for k, p in gpt.named_parameters()}
    generator = torch.Generator(device=dev).manual_seed(lseed + 1)
    losses, grads = [], None
    res = cfg.vqgan.codec.resolution
    for i, (epoch, k) in enumerate(served):
        order = data.epoch_order(n, lseed, epoch, True)
        pick = [entries[j] for j in order[k * b:(k + 1) * b]]
        with torch.no_grad():
            x = torch.from_numpy(data.decode([e[0] for e in pick], res)).to(
                dev)
            _, idx, _ = vq.encode(x)
            z = idx.reshape(idx.shape[0], -1)
            ids = torch.from_numpy(tokenize(
                tok, [e[1] for e in pick],
                cfg.clip.context_length)).long().to(dev)
            embeds, _ = clip(ids)
            mask = ids > 0
        for p in opt.params:
            p.grad = None
        loss = gpt_loss(gpt, cfg, z[rows], embeds.float()[rows], mask[rows],
                        generator)
        loss.backward()
        opt.step(sched(i))
        losses.append({"loss_gpt": float(loss.detach())})
        if i == 0:
            grads = {k: v.clone() for k, v in _mu_grads(opt).items()}
    changes = favae.changes(gpt, start, dev)
    del gpt, opt, start, vq, clip
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads, changes


def check(st, ctx):
    from benchmark.drivers.favae_train import compare
    st.feed.close()
    del st.trainer
    gc.collect()
    torch.cuda.empty_cache()
    tr = ctx.cell.traffic
    ref = reference_steps(ctx, st.seed, st.manifest, st.first)
    got = compare(st.losses, st.grads, st.changes, ref, ["loss_gpt"])
    print("detail " + json.dumps(got["detail"]), file=sys.stderr)
    return [Check(k, got[k], tr["limits"][k]) for k in tr["limits"]]


def control(ctx) -> dict:
    """The control (the reference's GPT projections in fp8) and the
    half-batch fault at the cell's own size, as `favae_train.control`."""
    from benchmark.drivers.favae_train import compare
    tr = ctx.cell.traffic
    manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                    tr["images"], tr["image_size"],
                                    ctx.device, with_captions=True)
    served = [(0, k) for k in range(tr["first_steps"])]
    ref = reference_steps(ctx, ctx.seed, manifest, served)
    out = {}
    for name, kw in (("control", {"fp8": True}),
                     ("half_batch", {"rows": slice(0, tr["batch"] // 2)})):
        losses, grads, changes = reference_steps(ctx, ctx.seed, manifest,
                                                 served, **kw)
        out[name] = compare(losses, favae.norms(grads), changes, ref,
                            ["loss_gpt"])
    return out


def counts(ctx) -> dict:
    """A step's matmul FLOPs (forward and backward, the GPT over the
    cached latents) from the reference's GPT on the meta device."""
    from benchmark import roofline
    from benchmark.reference import config as RC
    from benchmark.reference.cat_train import gpt_loss
    from benchmark.reference.gpt import GPT
    cfg = cat.cat_config(RC, ctx.cell.config)
    b = ctx.cell.traffic["batch"]
    with torch.device("meta"):
        gpt = GPT(cfg.gpt).train()
    seq = cfg.gpt.image_encoded_dim ** 2
    z = torch.zeros(b, seq, dtype=torch.long, device="meta")
    embeds = torch.empty(b, cfg.clip.context_length, cfg.gpt.n_cond_embed,
                         device="meta")
    mask = torch.ones(b, cfg.clip.context_length, dtype=torch.bool,
                      device="meta")

    def step():
        gpt_loss(gpt, cfg, z, embeds, mask, None, train=False).backward()
    return {"flops_per_step": roofline.count_flops(step)}
