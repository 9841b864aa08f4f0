"""Reconstruction evaluation on the card: PSNR / L1 / codebook usage.

The port's counterpart of `favae_tpu/cli/eval_favae.py`: encode -> quantize
-> decode every image of the eval set and print one JSON line with `psnr`,
`l1`, `codebook_usage` and `images`. Weights come from a reference-format
`.pt` (`--torch_ckpt`) or, without one, are random from seed 0.

    python -m favae_tpu_torch.cli.eval_favae --preset celebahq_expe5 \
        --torch_ckpt expe_5.pt --test_file celeba_test.pkl

LPIPS, rFID and Orbax checkpoints are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

_NOT_PORTED = ("orbax_ckpt", "lpips_ckpt", "inception_ckpt")


def build_parser():
    from favae_tpu_torch.config import PRESETS
    p = argparse.ArgumentParser(description="Evaluate FA-VAE reconstructions")
    p.add_argument("--preset", type=str, default="celebahq_expe5",
                   choices=[k for k in PRESETS if k != "cat_celebahq"])
    p.add_argument("--torch_ckpt", type=str, default=None,
                   help="reference-format .pt checkpoint")
    p.add_argument("--test_file", type=str, default=None)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    for flag in _NOT_PORTED:
        p.add_argument(f"--{flag}", type=str, default=None,
                       help="not yet ported to favae_tpu_torch")
    return p


def psnr(x, y, data_range: float = 2.0):
    """Per-image PSNR over [-1, 1] images (range 2)."""
    mse = torch.mean((x - y) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse)


def main(argv=None):
    """Run the evaluation; returns the printed metrics plus `batch_ms`, the
    wall time of each batch from host input to metrics back on the host."""
    args = build_parser().parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not yet ported to favae_tpu_torch")
    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.config import PRESETS
    from favae_tpu_torch.convert import load_reference_checkpoint
    from favae_tpu_torch.data.pipeline import (DataLoader, PklImageDataset,
                                               SyntheticDataset)
    from favae_tpu_torch.models.vqgan import build_model

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]()
    model = build_model(cfg, device)
    if args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)

    if args.synthetic_data or args.test_file is None:
        ds = SyntheticDataset(resolution=args.resolution, size=64)
    else:
        ds = PklImageDataset(args.test_file, resolution=args.resolution)
    loader = DataLoader(ds, batch_size=args.batch_size,
                        num_workers=args.num_workers)

    psnrs, l1s, batch_ms = [], [], []
    used = np.zeros(cfg.quantizer.codebook_size, bool)
    seen = 0
    with torch.inference_mode():
        for x in loader:
            t0 = time.perf_counter()
            xt = torch.from_numpy(x).to(device)
            x_recon, idx = model.reconstruct(xt)
            psnrs.append(psnr(xt, x_recon).cpu().numpy())
            l1s.append(torch.mean(torch.abs(xt - x_recon),
                                  dim=(1, 2, 3)).cpu().numpy())
            used[np.unique(idx.cpu().numpy())] = True
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            seen += x.shape[0]
            if args.max_images and seen >= args.max_images:
                break

    metrics = {
        "psnr": float(np.mean(np.concatenate(psnrs))),
        "l1": float(np.mean(np.concatenate(l1s))),
        "codebook_usage": float(used.mean()),
        "images": seen,
    }
    print(json.dumps(metrics))
    return {**metrics, "batch_ms": batch_ms}


if __name__ == "__main__":
    main()
