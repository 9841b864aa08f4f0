"""Driver `favae_train`: FA-VAE training through `FavaeTrainer.train_epoch`
as `cli/train_favae.py` builds the trainer, fed by the port's `DataLoader`
over a `PklImageDataset` manifest of the seed's JPEG files.

Set-up builds one trainer, loads the seed's weights, and drives it through
its first steps with the window's own call and feed (`first_steps`, on rows
that all differ), keeping each step's losses, the first gradient as Adam
got it, the quantizer's EMA code counts after the first step and the
change of the parameters and floating buffers after them all; then
`warmup_steps` more.
The window hands the same trainer the same feed until the deadline. The
check runs the reference (float32, TF32 off) over the same three batches,
decoded from the files by the reference's own loader, from the same
weights, and compares the losses, the gradient norms, the change norms
leaf by leaf and the code counts.

Traffic parameters: images, image_size, resolution, loader_threads,
first_steps, warmup_steps, trace_seconds, limits.
"""

from __future__ import annotations

import gc
import json
import sys

import torch

from benchmark import data, favae
from benchmark.feed import Feed
from benchmark.harness import Check, Window


class State:
    pass


def setup(ctx):
    from favae_tpu_torch import config as PC
    from favae_tpu_torch.data.pipeline import DataLoader, PklImageDataset
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    st = State()
    st.seed = ctx.seed
    st.lseed = favae.loader_seed(ctx.seed)
    model_cfg, loss_cfg, train_cfg = favae.configs(PC, cfg, st.lseed)
    st.batch = train_cfg.batch_size
    dev = ctx.device
    st.manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                       tr["images"], tr["image_size"], dev)
    model_sd, lpips_sd = favae.make_weights(cfg, ctx.seed, dev)
    trainer = FavaeTrainer(model_cfg, loss_cfg, train_cfg,
                           str(ctx.workdir / "run"), device=dev,
                           lpips_state_dict=lpips_sd,
                           log_dir=str(ctx.workdir / "runs"))
    trainer.state.model.load_state_dict(model_sd)
    del lpips_sd
    loader = DataLoader(
        PklImageDataset(str(st.manifest), tr["resolution"],
                        output_dtype="float32"),
        st.batch, num_workers=tr["loader_threads"], shuffle=True,
        seed=train_cfg.seed)
    st.feed = Feed(loader, ctx)
    model = trainer.state.model
    trainer.train_epoch(st.feed.take(1), 0)
    st.grads = favae.norms(favae.adam_grads(
        [trainer.state.opt_g, trainer.state.opt_d], model))
    st.codes = favae.code_counts(model)
    trainer.train_epoch(st.feed.take(tr["first_steps"] - 1), 0)
    st.changes = favae.changes(model, model_sd)
    del model_sd
    st.losses = [scalars(h) for h in trainer.history]
    st.first = list(st.feed.served)
    trainer.train_epoch(st.feed.take(tr["warmup_steps"]), 0)
    st.trainer = trainer
    return st


def window(st, ctx) -> Window:
    batches = st.feed.until_deadline()
    t0 = ctx.open_window()
    st.trainer.train_epoch(batches, 1)
    t1 = ctx.close_window()
    n = batches.count
    return Window(t0, t1, n, {"train_samples_per_s": n * st.batch / (t1 - t0)},
                  extra={"work_span": "step", "samples_per_step": st.batch})


def reference_steps(ctx, seed: int, manifest, served, fp8: bool = False,
                    rows: slice = slice(None)):
    """The reference's losses, first gradients, changes (tensors) and code
    counts after the first step, over the batches `served` ((epoch, batch)
    of the loader's order), read from the files; `fp8` the control's
    precision, `rows` a fault's cut of each batch."""
    from benchmark.reference.favae_step import make_train_step
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, (model_cfg, loss_cfg, train_cfg) = favae.reference_state(
        cfg, seed, dev, fp8=fp8)
    step = make_train_step(model_cfg, loss_cfg, train_cfg, disc_on=True,
                           ffl_on=True)
    paths = data.read_manifest(manifest)
    start = {n: p.detach().clone() for n, p in
             [*state.model.named_parameters(), *state.model.named_buffers()]}
    losses, grads, codes = [], None, None
    b = train_cfg.batch_size
    for i, (epoch, k) in enumerate(served):
        order = data.epoch_order(len(paths), favae.loader_seed(seed), epoch,
                                 True)
        x = data.decode([paths[j] for j in order[k * b:(k + 1) * b]],
                        tr["resolution"])
        xt = torch.from_numpy(x[rows]).to(dev)
        _, m = step(state, xt)
        losses.append(scalars({k: float(v) for k, v in m.items()
                               if v.dim() == 0}))
        if i == 0:
            grads = {k: v.clone() for k, v in favae.adam_grads(
                [state.opt_g, state.opt_d], state.model).items()}
            codes = favae.code_counts(state.model)
    changes = favae.changes(state.model, start, dev)
    del state, start
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads, changes, codes


def scalars(row: dict) -> dict:
    """A step's losses and adaptive weight, by name."""
    return {k: float(v) for k, v in row.items()
            if k.startswith("loss") or k == "weight_d"}


def compare(losses, grads, changes, ref, keys, codes=None) -> dict:
    """The numbers: `loss_gap`, the first step's largest relative gap of the
    losses `keys` (the later steps' in `detail`); `grad_gap`, the median
    leaf's gap of first-gradient norms (`grads` by leaf; the worst leaf's
    in `detail`); `change_gap`, the worst leaf's gap of change norms over
    the parameters' entries the reference's gradient moves and the floating
    buffers the reference moves (`changes` and the reference's as tensors);
    with `codes`, the EMA code counts after the first step, `code_mismatch`
    and `count_gap` (`favae.code_numbers`); and under `detail` where each
    was read."""
    r_losses, r_grad_t, r_change_t = ref[:3]
    by_step = {k: [favae.rel(p[k], r[k]) for p, r in zip(losses, r_losses)]
               for k in r_losses[0] if k in losses[0]}
    loss_gap, loss_at = max((by_step[k][0], k) for k in keys)
    r_grads = favae.norms(r_grad_t)
    grad_gap, grad_at = favae.leaf_gap(grads, r_grads, list(r_grads),
                                       median=True)
    grad_worst, worst_at = favae.leaf_gap(grads, r_grads, list(r_grads))
    masks = favae.moved_elements(r_grad_t)
    for k, c in r_change_t.items():  # a buffer: every entry, no gradient
        masks.setdefault(k, torch.ones_like(c, dtype=torch.bool))
    port_c = favae.masked_norms(changes, masks)
    ref_c = favae.masked_norms(r_change_t, masks)
    moved = [k for k, m in masks.items() if bool(m.any()) and ref_c[k] > 0]
    change_gap, change_at = favae.leaf_gap(port_c, ref_c, moved)
    left_out = sum(int((~m).sum()) for m in masks.values())
    out = {}
    if codes is not None:
        out["code_mismatch"], out["count_gap"] = favae.code_numbers(
            codes, ref[3])
    return {**out, "loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "detail": {"loss_gap": f"step 1 {loss_at}: "
                                   f"{losses[0][loss_at]!r} vs "
                                   f"{r_losses[0][loss_at]!r}",
                       "grad_gap": f"{grad_at}: {grads[grad_at]!r} vs "
                                   f"{r_grads[grad_at]!r}",
                       "grad_gap_worst": [grad_worst, worst_at],
                       "change_gap": f"{change_at}: {port_c[change_at]!r} "
                                     f"vs {ref_c[change_at]!r}",
                       "change_gap_median": favae.leaf_gap(
                           port_c, ref_c, moved, median=True)[0],
                       "entries_left_out": left_out,
                       "losses_by_step": by_step}}


def checks(got: dict, limits: dict):
    """The numbers with a limit; the others are printed beside the detail."""
    shown = {k: v for k, v in got.items() if k != "detail" and k not in limits}
    print("detail " + json.dumps({**got["detail"], "not_compared": shown}),
          file=sys.stderr)
    return [Check(k, got[k], limits[k]) for k in limits]


def check(st, ctx):
    st.feed.close()
    del st.trainer
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_steps(ctx, st.seed, st.manifest, st.first)
    tr = ctx.cell.traffic
    got = compare(st.losses, st.grads, st.changes, ref, tr["loss_keys"],
                  st.codes)
    return checks(got, tr["limits"])


def control(ctx) -> dict:
    """The control and the planted faults at the cell's own size, from the
    reference put in the program's place: `control` the reference in fp8,
    `half_batch` each batch's first half, the mean over it. A state left
    unchanged reads change_gap 1 by construction and needs no run."""
    tr = ctx.cell.traffic
    manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                    tr["images"], tr["image_size"],
                                    ctx.device)
    served = [(0, k) for k in range(tr["first_steps"])]
    ref = reference_steps(ctx, ctx.seed, manifest, served)
    b = ctx.cell.config["train"]["batch_size"]
    out = {}
    for name, kw in (("control", {"fp8": True}),
                     ("half_batch", {"rows": slice(0, b // 2)})):
        losses, grads, changes, codes = reference_steps(
            ctx, ctx.seed, manifest, served, **kw)
        out[name] = compare(losses, favae.norms(grads), changes, ref,
                            tr["loss_keys"], codes)
    return out


def counts(ctx) -> dict:
    """A step's matmul and convolution FLOPs and its GroupNorm calls'
    bytes, from the reference's modules at the configuration's shapes and
    stated precision, on the meta device."""
    from benchmark import roofline
    from benchmark.reference import config as RC
    from benchmark.reference.favae_state import FavaeTrainState
    from benchmark.reference.favae_state import make_optimizers
    from benchmark.reference.favae_step import make_train_step
    from benchmark.reference.lpips import LPIPS
    from benchmark.reference.vqgan import VQGANFCM
    model_cfg, loss_cfg, train_cfg = favae.configs(RC, ctx.cell.config, 0)
    dt = getattr(torch, model_cfg.compute_dtype)
    with torch.device("meta"):
        model = VQGANFCM(model_cfg, loss_cfg.gaussian_kernel,
                         loss_cfg.dsl_init_sigma)
        lpips = LPIPS(dt)
    opt_g, opt_d = make_optimizers(model, train_cfg, 1e-4)
    state = FavaeTrainState(model=model, lpips=lpips, opt_g=opt_g,
                            opt_d=opt_d)
    step = make_train_step(model_cfg, loss_cfg, train_cfg, disc_on=True,
                           ffl_on=True)
    r = ctx.cell.traffic["resolution"]
    x = torch.empty(train_cfg.batch_size, r, r, 3, device="meta")
    gn = roofline.GroupNormCalls()
    with gn.watch(model):
        flops = roofline.count_flops(
            lambda: step(state, x))
    return {"flops_per_step": flops, "gn_bytes_per_step": gn.bytes()}
