"""Train CAT on the card, with the JAX CLI's flag surface.

The port's counterpart of `favae_tpu/cli/train_cat.py` (reference:
cat_scripts/train_cat.py:247-319), plus `--device` (CUDA unless `--device
cpu` is passed), `--synthetic_steps`, `--profile` and `--output_dir`.
Launch:

    python -m favae_tpu_torch.cli.train_cat --ds cat_run \\
        --codebook_size 1024 --embed_dim 256 --use_same_gauss_resblock \\
        --gaussian_kernel 3 --clip vit-l-14 --n_cond_embed 768 \\
        --txt_tok_cond --enabled_warmup --favae_ckpt expe_7_mu9.pt \\
        --clip_ckpt ViT-L-14.pt --bpe_vocab bpe_simple_vocab_16e6.txt.gz \\
        --train_file celeba_train_w_cap.pkl --val_file celeba_test_w_cap.pkl

Without `--favae_ckpt` / `--clip_ckpt` the frozen towers are random from
the seed; without `--bpe_vocab` the tokenizer is the JAX CLI's few-merge
stub. Each epoch writes `<output_dir>/cat/<ds>/latest` (and `best` on
improvement; `--save_every_epoch N` for every Nth epoch and the last):
the GPT, its AdamW moments, the step and the dropout generator.
TensorBoard scalars and sample previews (every `--img_steps` global steps
and after each validation) go to `<output_dir>/cat/<ds>/runs`. `--resume`
continues from `latest`; `--resume_path` names a checkpoint directory or
a reference-format `.pt` (GPT weights only, fresh AdamW). `--gpt_unroll`
and `--dropout_rng` are accepted and ignored: the port has no layer scan
and draws from one `torch.Generator`. `main` returns the run's per-step
and validation metrics.

Over N processes the ranks form a (N / tp, tp) grid (`--tp`, tensor
parallelism of the GPT): `--batch_size` samples a rank, so a dp group
loads batch_size * tp samples a step and the global batch is
batch_size * N, as the JAX CLI's batch per device; lr = base_lr *
batch_size * N. Each rank runs on `cuda:LOCAL_RANK`:

    python -m torch.distributed.run --nproc_per_node N \
        -m favae_tpu_torch.cli.train_cat --ds cat_run --tp 2 ...

`--dist_backend` picks nccl (the default on CUDA) or gloo (the default on
the CPU, and the one that runs several ranks on one card named by
`--device cuda:0`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train CAT (PyTorch/CUDA)")
    p.add_argument("--ds", type=str, required=True, help="output run name")
    p.add_argument("--gpt_name", type=str, default="gpt2_medium",
                   choices=["gpt2_mini", "gpt2_medium", "gpt2_large"])
    p.add_argument("--gpt_remat", type=str, default="none",
                   choices=["full", "dots", "dots_nb", "none"],
                   help="activation checkpointing of the GPT blocks (same "
                        "math): none keeps every activation, which an 80 GB "
                        "card holds at gpt2_medium batch 16; full recomputes "
                        "each block in the backward; dots / dots_nb keep the "
                        "products' outputs (all / the projections only)")
    p.add_argument("--gpt_unroll", type=int, default=1,
                   help="ignored: the port runs its blocks as a Python loop, "
                        "with no layer scan to unroll")
    p.add_argument("--dropout_rng", type=str, default="rbg",
                   choices=["rbg", "threefry"],
                   help="ignored: dropout draws from one torch.Generator")
    p.add_argument("--fold_ln_scale", action="store_true",
                   help="fold each pre-projection LayerNorm gamma into the "
                        "next projection's weight (same function of the "
                        "same parameters)")
    p.add_argument("--adam_mu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of Adam's first moment")
    p.add_argument("--adam_nu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of Adam's second moment")
    p.add_argument("--clip", type=str, default="vit-l-14",
                   choices=["vit-b-32", "vit-l-14"])
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--base_lr", type=float, default=2e-6)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into N equal micro-batches and "
                        "apply one update from their averaged grads; "
                        "batch_size must be divisible by N")
    p.add_argument("--cache_latents", action="store_true",
                   help="run the frozen FA-VAE and CLIP encodes once before "
                        "training and train the GPT from the cache (~237 KB "
                        "of host memory a sample with ViT-L/14)")
    p.add_argument("--save_every_epoch", type=int, default=1,
                   help="checkpoint every Nth epoch and the last; 0 writes "
                        "none (port only)")
    p.add_argument("--favae_ckpt", type=str, default=None,
                   help="reference-format FA-VAE checkpoint (.pt); random "
                        "first stage without")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="OpenAI CLIP checkpoint (.pt) for the text tower")
    p.add_argument("--bpe_vocab", type=str, default=None,
                   help="bpe_simple_vocab_16e6.txt.gz path")
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--double_z", action="store_true")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--warmup_epochs", type=int, default=20)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--top_k", type=int, default=500)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--normalize_clip", action="store_true")
    p.add_argument("--enabled_warmup", action="store_true")
    p.add_argument("--print_steps", type=int, default=10)
    p.add_argument("--img_steps", type=int, default=1000)
    p.add_argument("--txt_tok_cond", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume_path", type=str, default=None,
                   help="explicit checkpoint to resume or warm-start from: "
                        "a checkpoint directory (full state) or a "
                        "reference-format CAT .pt (GPT weights only). "
                        "Default: <output_dir>/cat/<ds>/latest (reference: "
                        "train_cat.py:199-204)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism of the GPT over this many ranks "
                        "of a torchrun launch (it must divide the world, "
                        "the heads and the FF width)")
    p.add_argument("--train_file", type=str, default=None)
    p.add_argument("--val_file", type=str, default=None)
    p.add_argument("--use_cosine_sim", action="store_true")
    p.add_argument("--use_l2_quantizer", action="store_true")
    p.add_argument("--codebook_dim", type=int, default=None)
    p.add_argument("--use_same_conv_gauss", action="store_true")
    p.add_argument("--use_same_gauss_resblock", action="store_true")
    p.add_argument("--use_gauss_resblock", action="store_true")
    p.add_argument("--use_gauss_attn", action="store_true")
    p.add_argument("--use_patch_discriminator", action="store_true")
    p.add_argument("--gaussian_kernel", type=int, default=3)
    p.add_argument("--n_cond_embed", type=int, default=768)
    p.add_argument("--disc_n_layers", type=int, default=3)
    p.add_argument("--downsample_factor", type=int, default=16)
    p.add_argument("--num_groups", type=int, default=32)
    p.add_argument("--dsl_init_sigma", type=float, default=3.0)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--synthetic_steps", type=int, default=32,
                   help="synthetic train batches an epoch (val: 4)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler over steps [2, 5) of the first "
                        "epoch; summary and trace in the run directory")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (each rank of a torchrun launch on "
                        "cuda:LOCAL_RANK), cuda:N (every rank on card N) "
                        "or cpu")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="process group backend under torchrun (default "
                        "nccl on CUDA, gloo on the CPU)")
    return p


def config_from_args(args):
    """The CATConfig, as favae_tpu/cli/train_cat.py:143-190 builds it."""
    from favae_tpu_torch import config as C

    if args.use_same_conv_gauss:
        fcm, dsl = C.FCM_CONV, C.DSL_PAIR
    elif args.use_same_gauss_resblock:
        fcm, dsl = C.FCM_RES, C.DSL_PAIR
    elif args.use_gauss_resblock:
        fcm, dsl = C.FCM_RES, C.DSL_NONPAIR
    elif args.use_gauss_attn:
        fcm, dsl = C.FCM_ATTN, C.DSL_NONPAIR
    else:
        fcm, dsl = C.FCM_RES, C.DSL_PAIR
    vqgan_cfg = C.VQGANConfig(
        codec=C.codec_for_downsample_factor(
            args.downsample_factor, resolution=args.resolution,
            z_channels=args.embed_dim, double_z=args.double_z,
            num_groups=args.num_groups),
        quantizer=C.QuantizerConfig(
            codebook_size=args.codebook_size, dim=args.embed_dim,
            codebook_dim=args.codebook_dim,
            use_cosine_sim=args.use_cosine_sim),
        discriminator=C.DiscriminatorConfig(
            kind="patch" if args.use_patch_discriminator else "conv",
            num_layers=args.disc_n_layers),
        fcm_kind=fcm, dsl_mode=dsl)
    gpt_factory = {"gpt2_mini": C.gpt2_mini, "gpt2_medium": C.gpt2_medium,
                   "gpt2_large": C.gpt2_large}[args.gpt_name]
    clip_cfg = (C.CLIPTextConfig() if args.clip == "vit-l-14"
                else C.CLIPTextConfig(width=512, heads=8, layers=12,
                                      embed_dim=512))
    return C.CATConfig(
        vqgan=vqgan_cfg,
        gpt=gpt_factory(vocab_size=args.codebook_size,
                        n_cond_embed=args.n_cond_embed, dropout=args.dropout,
                        remat=args.gpt_remat, train_unroll=args.gpt_unroll,
                        dropout_rng_impl=args.dropout_rng,
                        fold_ln_scale=args.fold_ln_scale),
        clip=clip_cfg, normalize_clip=args.normalize_clip,
        top_k=args.top_k, top_p=args.top_p, base_lr=args.base_lr,
        warmup_epochs=args.warmup_epochs, epochs=args.epochs,
        min_lr=args.min_lr, adam_mu_dtype=args.adam_mu_dtype,
        adam_nu_dtype=args.adam_nu_dtype)


def main(argv=None, cfg=None):
    """Train; returns {"lr", "start_epoch", "history" (one dict a step:
    loss_gpt, lr, step_ms), "val" (one dict an epoch), "precompute_s",
    "profile" (or None), "summary" (`run_summary`, also printed)}. `cfg`
    replaces the CATConfig that the flags resolve to."""
    args = build_parser().parse_args(argv)
    import torch

    from favae_tpu_torch.convert import (load_reference_checkpoint,
                                         load_reference_clip_text)
    from favae_tpu_torch.data.pipeline import (DataLoader, PklImageDataset,
                                               SyntheticDataset)
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu_torch.models.txt_cond import build_cat
    from favae_tpu_torch.parallel.mesh import is_main_process, start_rank
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    from favae_tpu_torch.utils.logging import print0

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device, mesh = start_rank(args.device, args.dist_backend, args.tp)
    cfg = cfg or config_from_args(args)
    save_path = os.path.join(args.output_dir, "cat", args.ds)
    os.makedirs(save_path, exist_ok=True)
    if is_main_process():
        with open(os.path.join(save_path, "train_cfg.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    if args.bpe_vocab:
        tokenizer = BPETokenizer(args.bpe_vocab)
    else:  # tiny synthetic merges, as the JAX CLI's
        tokenizer = BPETokenizer(merges=["s y", "sy n", "syn t"])
    cat = build_cat(cfg, device, seed=args.seed, tokenizer=tokenizer)
    if args.favae_ckpt:
        load_reference_checkpoint(cat.favae, args.favae_ckpt)
        print0(f"loaded FA-VAE first stage from {args.favae_ckpt}")
    if args.clip_ckpt:
        load_reference_clip_text(cat.clip, args.clip_ckpt)
        print0(f"loaded CLIP text tower from {args.clip_ckpt}")

    res, batch = cfg.vqgan.codec.resolution, args.batch_size
    world = mesh.world if mesh is not None else 1
    # a dp group's tp ranks share batch * tp samples a step
    group_batch = batch * args.tp
    shard = (dict(shard_index=mesh.dp.rank, shard_count=mesh.dp.size)
             if mesh is not None else {})
    if args.synthetic_data or args.train_file is None:
        train_ds = SyntheticDataset(res, size=args.synthetic_steps * batch
                                    * world, with_captions=True)
        val_ds = SyntheticDataset(res, size=4 * batch * world, seed=7,
                                  with_captions=True)
    else:
        train_ds = PklImageDataset(args.train_file, res, with_captions=True)
        val_ds = (PklImageDataset(args.val_file, res, with_captions=True)
                  if args.val_file else None)
    train_dl = DataLoader(train_ds, group_batch, num_workers=args.num_workers,
                          shuffle=True, seed=args.seed, **shard)
    val_dl = (DataLoader(val_ds, group_batch, num_workers=args.num_workers,
                         **shard) if val_ds else None)

    trainer = CATTrainer(cfg, save_path, steps_per_epoch=len(train_dl),
                         batch_size=batch, device=device,
                         enabled_warmup=args.enabled_warmup, seed=args.seed,
                         grad_accum=args.grad_accum,
                         cache_latents=args.cache_latents, cat=cat,
                         log_dir=os.path.join(save_path, "runs"),
                         save_every_epoch=args.save_every_epoch,
                         enable_profiler=args.profile, mesh=mesh)
    if args.resume or args.resume_path:
        trainer.resume(args.resume_path)
    print0(f"device={device} world={world} tp={args.tp} lr={trainer.lr:.3e} "
           f"batch={batch} global_batch={batch * world} "
           f"grad_accum={args.grad_accum} steps/epoch={len(train_dl)} "
           f"cache_latents={args.cache_latents}")
    trainer.fit(train_dl, val_dl, print_steps=args.print_steps,
                img_steps=args.img_steps)
    summary = run_summary(trainer.history, batch * world, device)
    print0("summary " + json.dumps(summary))
    return {"lr": trainer.lr, "start_epoch": trainer.start_epoch,
            "history": trainer.history, "val": trainer.val,
            "precompute_s": trainer.precompute_s, "profile": trainer.profile,
            "summary": summary}


def run_summary(history, batch: int, device) -> dict:
    """The steady step time (the median over all steps but the first two of
    the run: CUDA events on the card, host clock on the CPU), samples/s,
    and on the card its name and the peak memory allocated."""
    import statistics

    import torch
    ms = [h["step_ms"] for h in history[2:]]
    steady = statistics.median(ms) if ms else float("nan")
    out = {"steps": len(history), "steady_ms_per_step": steady,
           "samples_per_s": batch * 1e3 / steady, "device": str(device)}
    if device.type == "cuda":
        out.update(device=torch.cuda.get_device_name(device),
                   max_memory_allocated_gib=(
                       torch.cuda.max_memory_allocated(device) / 2 ** 30))
    return out


if __name__ == "__main__":
    main()
