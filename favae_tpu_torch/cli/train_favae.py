"""Train FA-VAE on the card, with the JAX CLI's flag surface.

The port's counterpart of `favae_tpu/cli/train_favae.py`: the same knob
names, `--preset` for the published configurations, plus `--device` (CUDA
unless `--device cpu` is passed) and `--synthetic_steps`. Launch:

    python -m favae_tpu_torch.cli.train_favae --ds myrun \\
        --preset celebahq_expe5 --train_file celeba_train.pkl \\
        --test_file celeba_test.pkl --lpips_ckpt vgg16_lpips.pt

`--lpips_ckpt` loads the reference's `vgg16_lpips.pt` state_dict as it is.
Flags whose path is not yet ported (checkpoint and resume, k-means init,
ActNorm, dead-code expiry, the orthogonal regulariser, bf16 Adam moments,
the uint8 and process loaders, image logging) raise when set. `main`
returns the run's per-step and validation metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

# flags that are not yet ported, with the value that leaves them off
_NOT_PORTED = {"resume": False, "resume_path": None, "save_every_epoch": None,
               "img_steps": None, "loader_uint8": False,
               "loader_processes": False, "kmeans_init": False,
               "use_actnorm": False, "threshold_ema_dead_code": 0.0,
               "orthogonal_reg_weight": 0.0,
               "orthogonal_reg_active_codes_only": False,
               "orthogonal_reg_max_codes": None, "adam_mu_dtype": "float32"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train FA-VAE (PyTorch/CUDA)")
    p.add_argument("--ds", type=str, required=True, help="output run name")
    p.add_argument("--preset", type=str, default=None,
                   help="published config preset (celebahq_expe5, "
                        "ffhq_table1, imagenet_f16, imagenet_f4)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--downsample_factor", type=int, default=16)
    p.add_argument("--save_every_epoch", type=int, default=None,
                   help="not yet ported (the port saves no checkpoint)")
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
                   help="not yet ported")
    p.add_argument("--loader_processes", action="store_true",
                   help="not yet ported")
    p.add_argument("--print_steps", type=int, default=10)
    p.add_argument("--img_steps", type=int, default=None,
                   help="not yet ported (no image logging)")
    p.add_argument("--base_lr", type=float, default=2.0e-6)
    p.add_argument("--adam_mu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 is not yet ported")
    p.add_argument("--resume", action="store_true", help="not yet ported")
    p.add_argument("--resume_path", type=str, default=None,
                   help="not yet ported")
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
    p.add_argument("--orthogonal_reg_active_codes_only", action="store_true",
                   help="not yet ported")
    p.add_argument("--orthogonal_reg_weight", type=float, default=0.0,
                   help="not yet ported")
    p.add_argument("--orthogonal_reg_max_codes", type=int, default=None,
                   help="not yet ported")
    p.add_argument("--ffl_weight", type=float, default=0.0)
    p.add_argument("--DSL_weight_features", type=float, default=0.0)
    p.add_argument("--SL_weight", type=float, default=0.0)
    p.add_argument("--gaussian_kernel", type=int, default=9)
    p.add_argument("--gaussian_sigma", type=float, default=3.0)
    p.add_argument("--dsl_init_sigma", type=float, default=3.0)
    p.add_argument("--use_patch_discriminator", action="store_true")
    p.add_argument("--use_actnorm", action="store_true",
                   help="not yet ported (ActNorm's data-dependent init)")
    p.add_argument("--disc_n_layers", type=int, default=3)
    p.add_argument("--kmeans_init", action="store_true",
                   help="not yet ported")
    p.add_argument("--kmeans_iters", type=int, default=10)
    p.add_argument("--threshold_ema_dead_code", type=float, default=0.0,
                   help="not yet ported")
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
    p.add_argument("--device", type=str, default="cuda")
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
        print_steps=args.print_steps, adam_mu_dtype=args.adam_mu_dtype)
    return model_cfg, loss_cfg, train_cfg


def main(argv=None):
    """Train; returns {"lr", "history" (one dict of scalars per step, with
    its step_ms), "val" (one dict per epoch), "profile" (or None)}."""
    args = build_parser().parse_args(argv)
    for flag, off in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(
                f"--{flag} is not yet ported to favae_tpu_torch")
    import torch

    from favae_tpu_torch.convert import read_lpips_checkpoint
    from favae_tpu_torch.data.pipeline import (DataLoader, PklImageDataset,
                                               SyntheticDataset)
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    model_cfg, loss_cfg, train_cfg = config_from_args(args)
    save_path = os.path.join(args.output_dir, args.ds)
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "train_cfg.json"), "w") as f:
        json.dump({"model": dataclasses.asdict(model_cfg),
                   "loss": dataclasses.asdict(loss_cfg),
                   "train": dataclasses.asdict(train_cfg)}, f, indent=2,
                  default=str)

    res = args.resolution or model_cfg.codec.resolution
    batch = train_cfg.batch_size
    if args.synthetic_data or args.train_file is None:
        train_ds = SyntheticDataset(res, size=args.synthetic_steps * batch)
        val_ds = SyntheticDataset(res, size=4 * batch, seed=7)
    else:
        train_ds = PklImageDataset(args.train_file, res)
        val_ds = PklImageDataset(args.test_file, res) if args.test_file \
            else None
    train_dl = DataLoader(train_ds, batch, num_workers=args.num_workers,
                          shuffle=True, seed=train_cfg.seed)
    val_dl = (DataLoader(val_ds, batch, num_workers=args.num_workers)
              if val_ds else None)

    lpips_sd = (read_lpips_checkpoint(args.lpips_ckpt) if args.lpips_ckpt
                else None)
    trainer = FavaeTrainer(model_cfg, loss_cfg, train_cfg, save_path,
                           device=args.device, lpips_state_dict=lpips_sd,
                           enable_profiler=args.profile)
    print(f"device={trainer.device} lr={trainer.lr:.3e} batch={batch} "
          f"steps/epoch={len(train_dl)}", flush=True)
    trainer.fit(train_dl, val_dl)
    return {"lr": trainer.lr, "history": trainer.history,
            "val": trainer.val, "profile": trainer.profile}


if __name__ == "__main__":
    main()
