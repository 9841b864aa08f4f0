"""Train FA-VAE on the card, with the JAX CLI's flag surface.

The port's counterpart of `favae_tpu/cli/train_favae.py`: the same knob
names, `--preset` for the published configurations, plus `--device` (CUDA
unless `--device cpu` is passed) and `--synthetic_steps`. Launch:

    python -m favae_tpu_torch.cli.train_favae --ds myrun \\
        --preset celebahq_expe5 --train_file celeba_train.pkl \\
        --test_file celeba_test.pkl --lpips_ckpt vgg16_lpips.pt

`--lpips_ckpt` loads the reference's `vgg16_lpips.pt` state_dict as it is.
Each epoch writes `<output_dir>/<ds>/latest` (and `best` on improvement;
`--save_every_epoch N` for every Nth epoch and the last), TensorBoard
scalars and recon grids go to `<output_dir>/<ds>/runs`. `--resume`
continues from `latest`; `--resume_path` names a checkpoint directory (the
full state) or a reference-format `.pt` (weights only, fresh optimizers,
epoch 0). `--loader_uint8` ships uint8 batches that the step normalises
on the card; `--loader_processes` decodes in worker processes. With
`--preset`, the model and loss flags are ignored, as in the JAX CLI.
`main` returns the run's per-step and validation metrics.

Data parallel over N processes, each on `cuda:LOCAL_RANK` (`--batch_size`
images a rank, lr = base_lr * batch * N, as the JAX CLI's batch per
device):

    python -m torch.distributed.run --nproc_per_node N \
        -m favae_tpu_torch.cli.train_favae --ds myrun ...

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
    p = argparse.ArgumentParser(description="Train FA-VAE (PyTorch/CUDA)")
    p.add_argument("--ds", type=str, required=True, help="output run name")
    p.add_argument("--preset", type=str, default=None,
                   help="published config preset (celebahq_expe5, "
                        "ffhq_table1, imagenet_f16, imagenet_f4)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--downsample_factor", type=int, default=16)
    p.add_argument("--save_every_epoch", type=int, default=1,
                   help="checkpoint every Nth epoch and the last; 0 writes "
                        "none (port only)")
    p.add_argument("--perceptual_weight", type=float, default=1.0)
    p.add_argument("--disc_weight", type=float, default=0.75)
    p.add_argument("--codebook_weight", type=float, default=1.0)
    p.add_argument("--disc_start_epochs", type=int, default=None)
    p.add_argument("--ffl_start_epochs", type=int, default=None)
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--codebook_dim", type=int, default=None)
    p.add_argument("--resolution", type=int, default=None,
                   help="image size (default: the model's, 256)")
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--loader_uint8", action="store_true",
                   help="ship uint8 batches, normalised on the device")
    p.add_argument("--loader_processes", action="store_true",
                   help="decode images in worker processes, not threads")
    p.add_argument("--print_steps", type=int, default=10)
    p.add_argument("--img_steps", type=int, default=100)
    p.add_argument("--base_lr", type=float, default=2.0e-6)
    p.add_argument("--adam_mu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of both Adams' first moments")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume_path", type=str, default=None,
                   help="explicit checkpoint to resume or warm-start from: "
                        "a checkpoint directory (full state) or a "
                        "reference-format .pt (weights only). Default: "
                        "<output_dir>/<ds>/latest (reference: "
                        "train_favae.py:334-341)")
    p.add_argument("--train_file", type=str, default=None)
    p.add_argument("--test_file", type=str, default=None)
    p.add_argument("--double_z", action="store_true")
    p.add_argument("--use_cosine_sim", action="store_true")
    p.add_argument("--use_l2_quantizer", action="store_true",
                   help="accepted for compatibility (always the l2 quantizer)")
    p.add_argument("--with_fcm", action="store_true")
    p.add_argument("--use_non_pair_conv", action="store_true")
    p.add_argument("--use_same_conv_gauss", action="store_true")
    p.add_argument("--use_same_gauss_resblock", action="store_true")
    p.add_argument("--use_gauss_resblock", action="store_true")
    p.add_argument("--use_gauss_attn", action="store_true")
    p.add_argument("--use_ffl_with_fcm", action="store_true")
    p.add_argument("--orthogonal_reg_active_codes_only", action="store_true")
    p.add_argument("--orthogonal_reg_weight", type=float, default=0.0)
    p.add_argument("--orthogonal_reg_max_codes", type=int, default=None)
    p.add_argument("--ffl_weight", type=float, default=0.0)
    p.add_argument("--DSL_weight_features", type=float, default=0.0)
    p.add_argument("--SL_weight", type=float, default=0.0)
    p.add_argument("--gaussian_kernel", type=int, default=9)
    p.add_argument("--gaussian_sigma", type=float, default=3.0)
    p.add_argument("--dsl_init_sigma", type=float, default=3.0)
    p.add_argument("--use_patch_discriminator", action="store_true")
    p.add_argument("--use_actnorm", action="store_true",
                   help="ActNorm in the PatchGAN, data-initialised from "
                        "the first batch")
    p.add_argument("--disc_n_layers", type=int, default=3)
    p.add_argument("--kmeans_init", action="store_true",
                   help="k-means codebook init on the first batch")
    p.add_argument("--kmeans_iters", type=int, default=10)
    p.add_argument("--threshold_ema_dead_code", type=float, default=0.0,
                   help="replace codes whose EMA count falls below this")
    p.add_argument("--num_groups", type=int, default=32)
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="the reference's vgg16_lpips.pt state_dict")
    p.add_argument("--synthetic_data", action="store_true",
                   help="train on synthetic data (smoke tests, benchmarks)")
    p.add_argument("--synthetic_steps", type=int, default=64,
                   help="synthetic train batches an epoch (val: 4)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (the reference's "
                        "train_favae.py:30)")
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
    """(model, loss, train) configs, as favae_tpu/cli/train_favae.py:113-196
    builds them."""
    from favae_tpu_torch import config as C

    if args.preset:
        if args.preset not in C.PRESETS or args.preset == "cat_celebahq":
            raise SystemExit(f"unknown preset '{args.preset}'")
        model_cfg = C.PRESETS[args.preset]()
        loss_cfg = {
            "celebahq_expe5": C.celebahq_expe5_losses,
            "ffhq_table1": C.ffhq_table1_losses,
            "imagenet_f16": C.imagenet_f16_losses,
            "imagenet_f4": C.imagenet_f4_losses,
        }[args.preset]()
        overrides = {}
        if args.disc_start_epochs is not None:
            overrides["disc_start_epochs"] = args.disc_start_epochs
        if args.ffl_start_epochs is not None:
            overrides["ffl_start_epochs"] = args.ffl_start_epochs
        if overrides:
            loss_cfg = dataclasses.replace(loss_cfg, **overrides)
    else:
        if args.use_non_pair_conv:
            fcm, dsl = C.FCM_CONV, C.DSL_NONPAIR
        elif args.use_same_conv_gauss:
            fcm, dsl = C.FCM_CONV, C.DSL_PAIR
        elif args.use_same_gauss_resblock:
            fcm, dsl = C.FCM_RES, C.DSL_PAIR
        elif args.use_gauss_resblock:
            fcm, dsl = C.FCM_RES, C.DSL_NONPAIR
        elif args.use_gauss_attn:
            fcm, dsl = C.FCM_ATTN, C.DSL_NONPAIR
        elif args.use_ffl_with_fcm:
            fcm, dsl = C.FCM_CONV, C.DSL_NONE
        else:
            fcm, dsl = C.FCM_NONE, C.DSL_NONE
        model_cfg = C.VQGANConfig(
            codec=C.codec_for_downsample_factor(
                args.downsample_factor, resolution=args.resolution or 256,
                z_channels=args.embed_dim, double_z=args.double_z,
                num_groups=args.num_groups),
            quantizer=C.QuantizerConfig(
                codebook_size=args.codebook_size, dim=args.embed_dim,
                codebook_dim=args.codebook_dim,
                use_cosine_sim=args.use_cosine_sim,
                commitment_weight=args.codebook_weight,
                kmeans_init=args.kmeans_init, kmeans_iters=args.kmeans_iters,
                threshold_ema_dead_code=args.threshold_ema_dead_code,
                orthogonal_reg_weight=args.orthogonal_reg_weight,
                orthogonal_reg_max_codes=args.orthogonal_reg_max_codes,
                orthogonal_reg_active_codes_only=(
                    args.orthogonal_reg_active_codes_only)),
            discriminator=C.DiscriminatorConfig(
                kind="patch" if args.use_patch_discriminator else "conv",
                num_layers=args.disc_n_layers, use_actnorm=args.use_actnorm),
            fcm_kind=fcm, dsl_mode=dsl, compute_dtype=args.compute_dtype)
        loss_cfg = C.LossConfig(
            perceptual_weight=args.perceptual_weight,
            disc_weight=args.disc_weight,
            codebook_weight=args.codebook_weight,
            ffl_weight=args.ffl_weight,
            dsl_weight=args.DSL_weight_features,
            sl_weight=args.SL_weight,
            gaussian_kernel=args.gaussian_kernel,
            gaussian_sigma=args.gaussian_sigma,
            dsl_init_sigma=args.dsl_init_sigma,
            disc_start_epochs=(1 if args.disc_start_epochs is None
                               else args.disc_start_epochs),
            ffl_start_epochs=(0 if args.ffl_start_epochs is None
                              else args.ffl_start_epochs),
            spectral_dtype=args.compute_dtype)

    train_cfg = C.TrainConfig(
        batch_size=args.batch_size, base_lr=args.base_lr, epochs=args.epochs,
        save_every_epoch=args.save_every_epoch, print_steps=args.print_steps,
        img_steps=args.img_steps, adam_mu_dtype=args.adam_mu_dtype)
    return model_cfg, loss_cfg, train_cfg


def main(argv=None):
    """Train; returns {"lr", "start_epoch", "history" (one dict of scalars
    per step, with its step_ms), "val" (one dict per epoch), "profile" (or
    None)}."""
    args = build_parser().parse_args(argv)
    import torch

    from favae_tpu_torch.convert import read_lpips_checkpoint
    from favae_tpu_torch.data.pipeline import (DataLoader, PklImageDataset,
                                               SyntheticDataset)
    from favae_tpu_torch.parallel.mesh import is_main_process, start_rank
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    from favae_tpu_torch.utils.logging import print0

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device, mesh = start_rank(args.device, args.dist_backend)
    model_cfg, loss_cfg, train_cfg = config_from_args(args)
    save_path = os.path.join(args.output_dir, args.ds)
    os.makedirs(save_path, exist_ok=True)
    if is_main_process():
        with open(os.path.join(save_path, "train_cfg.json"), "w") as f:
            json.dump({"model": dataclasses.asdict(model_cfg),
                       "loss": dataclasses.asdict(loss_cfg),
                       "train": dataclasses.asdict(train_cfg)}, f, indent=2,
                      default=str)

    res = args.resolution or model_cfg.codec.resolution
    batch = train_cfg.batch_size
    world = mesh.world if mesh is not None else 1
    shard = (dict(shard_index=mesh.dp.rank, shard_count=mesh.dp.size)
             if mesh is not None else {})
    if args.synthetic_data or args.train_file is None:
        train_ds = SyntheticDataset(res, size=args.synthetic_steps * batch
                                    * world)
        val_ds = SyntheticDataset(res, size=4 * batch * world, seed=7)
    else:
        dtype = "uint8" if args.loader_uint8 else "float32"
        train_ds = PklImageDataset(args.train_file, res, output_dtype=dtype)
        val_ds = (PklImageDataset(args.test_file, res, output_dtype=dtype)
                  if args.test_file else None)
    train_dl = DataLoader(train_ds, batch, num_workers=args.num_workers,
                          shuffle=True, seed=train_cfg.seed,
                          use_processes=args.loader_processes, **shard)
    val_dl = (DataLoader(val_ds, batch, num_workers=args.num_workers,
                         use_processes=args.loader_processes, **shard)
              if val_ds else None)

    lpips_sd = (read_lpips_checkpoint(args.lpips_ckpt) if args.lpips_ckpt
                else None)
    trainer = FavaeTrainer(model_cfg, loss_cfg, train_cfg, save_path,
                           device=device, lpips_state_dict=lpips_sd,
                           log_dir=os.path.join(save_path, "runs"),
                           enable_profiler=args.profile, mesh=mesh)
    if args.resume or args.resume_path:
        trainer.resume(args.resume_path)
    print0(f"device={trainer.device} world={world} lr={trainer.lr:.3e} "
           f"batch={batch} global_batch={batch * world} "
           f"steps/epoch={len(train_dl)}")
    try:
        trainer.fit(train_dl, val_dl)
    finally:
        for dl in (train_dl, val_dl):
            if dl is not None:
                dl.close()
    return {"lr": trainer.lr, "start_epoch": trainer.start_epoch,
            "history": trainer.history,
            "val": trainer.val, "profile": trainer.profile}


if __name__ == "__main__":
    main()
