"""Reconstruction evaluation on the card: PSNR / L1 / LPIPS / rFID /
codebook usage.

The port's counterpart of `favae_tpu/cli/eval_favae.py`: encode -> quantize
-> decode every image of the eval set and print one JSON line with `psnr`,
`l1`, `codebook_usage`, `images`, with `--lpips_ckpt` (the reference's
`vgg16_lpips.pt`) `lpips`, and with `--inception_ckpt` (pytorch-fid's
`pt_inception-2015-12-05` state_dict) `rfid`: the Fréchet distance between
the InceptionV3 features of the inputs and of their reconstructions, both
computed in the model's compute dtype. Weights come from a
reference-format `.pt` (`--torch_ckpt`), a port checkpoint directory
(`--orbax_ckpt`, `latest` / `best` of `train_favae`) or, without either,
are random from seed 0. `--save_recons DIR` writes side-by-side
[input | recon] PNGs of the first batches, 64 images at least.

    python -m favae_tpu_torch.cli.eval_favae --preset celebahq_expe5 \
        --torch_ckpt expe_5.pt --test_file celeba_test.pkl \
        --lpips_ckpt vgg16_lpips.pt \
        --inception_ckpt pt_inception-2015-12-05.pt --save_recons recons
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

def build_parser():
    from favae_tpu_torch.config import PRESETS
    p = argparse.ArgumentParser(description="Evaluate FA-VAE reconstructions")
    p.add_argument("--preset", type=str, default="celebahq_expe5",
                   choices=[k for k in PRESETS if k != "cat_celebahq"])
    p.add_argument("--torch_ckpt", type=str, default=None,
                   help="reference-format .pt checkpoint")
    p.add_argument("--orbax_ckpt", type=str, default=None,
                   help="favae_tpu_torch checkpoint dir (latest/best)")
    p.add_argument("--test_file", type=str, default=None)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="the reference's vgg16_lpips.pt state_dict")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="pytorch-fid inception weights for rFID")
    p.add_argument("--save_recons", type=str, default=None,
                   help="directory for side-by-side [input | recon] PNGs")
    return p


def psnr(x, y, data_range: float = 2.0):
    """Per-image PSNR over [-1, 1] images (range 2)."""
    mse = torch.mean((x - y) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse)


def main(argv=None):
    """Run the evaluation; returns the printed metrics plus `batch_ms`, the
    wall time of each batch from host input to metrics back on the host."""
    args = build_parser().parse_args(argv)
    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.config import PRESETS
    from favae_tpu_torch.convert import (load_reference_checkpoint,
                                         read_lpips_checkpoint)
    from favae_tpu_torch.data.pipeline import (DataLoader, PklImageDataset,
                                               SyntheticDataset)
    from favae_tpu_torch.models.lpips import LPIPS
    from favae_tpu_torch.models.vqgan import build_model

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]()
    state = None
    if args.orbax_ckpt and not args.torch_ckpt:  # read before building
        from favae_tpu_torch.utils.checkpoint import restore_checkpoint
        state, _ = restore_checkpoint(args.orbax_ckpt, "cpu")
    model = build_model(cfg, device)
    if args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)
    elif state is not None:
        model.load_state_dict(state["model"], strict=True)
        del state
    inception = None
    if args.inception_ckpt:
        from favae_tpu_torch.models.inception import (InceptionV3FID,
                                                      load_inception)
        inception = InceptionV3FID(getattr(torch, cfg.compute_dtype))
        load_inception(inception, args.inception_ckpt)
        inception.to(device).eval()
    if args.save_recons:
        from PIL import Image
        os.makedirs(args.save_recons, exist_ok=True)
    lpips = None
    if args.lpips_ckpt:
        lpips = LPIPS(getattr(torch, cfg.compute_dtype))
        lpips.load_state_dict(read_lpips_checkpoint(args.lpips_ckpt))
        lpips.to(device)

    if args.synthetic_data or args.test_file is None:
        ds = SyntheticDataset(resolution=args.resolution, size=64)
    else:
        ds = PklImageDataset(args.test_file, resolution=args.resolution)
    loader = DataLoader(ds, batch_size=args.batch_size,
                        num_workers=args.num_workers)

    psnrs, l1s, lpipss, batch_ms = [], [], [], []
    feats_r, feats_f = [], []
    used = np.zeros(cfg.quantizer.codebook_size, bool)
    seen = saved = 0
    with torch.inference_mode():
        for x in loader:
            t0 = time.perf_counter()
            xt = torch.from_numpy(x).to(device)
            x_recon, idx = model.reconstruct(xt)
            psnrs.append(psnr(xt, x_recon).cpu().numpy())
            l1s.append(torch.mean(torch.abs(xt - x_recon),
                                  dim=(1, 2, 3)).cpu().numpy())
            if lpips is not None:
                lpipss.append(lpips(xt, x_recon).float().cpu().numpy())
            if inception is not None:
                feats_r.append(inception(xt).cpu().numpy())
                feats_f.append(inception(x_recon).cpu().numpy())
            used[np.unique(idx.cpu().numpy())] = True
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            if args.save_recons and saved < 64:  # whole batches, as JAX's
                xr = x_recon.float().cpu().numpy()
                for i in range(x.shape[0]):
                    pair = np.clip(np.concatenate([x[i], xr[i]], axis=1)
                                   * 0.5 + 0.5, 0, 1)
                    Image.fromarray((pair * 255).astype(np.uint8)).save(
                        os.path.join(args.save_recons,
                                     f"recon_{saved:04d}.png"))
                    saved += 1
            seen += x.shape[0]
            if args.max_images and seen >= args.max_images:
                break

    metrics = {
        "psnr": float(np.mean(np.concatenate(psnrs))),
        "l1": float(np.mean(np.concatenate(l1s))),
        "codebook_usage": float(used.mean()),
        "images": seen,
    }
    if lpipss:
        metrics["lpips"] = float(np.mean(np.concatenate(lpipss)))
    if feats_r:
        from favae_tpu_torch.models.inception import fid_from_features
        metrics["rfid"] = fid_from_features(np.concatenate(feats_r),
                                            np.concatenate(feats_f))
    print(json.dumps(metrics))
    return {**metrics, "batch_ms": batch_ms}


if __name__ == "__main__":
    main()
