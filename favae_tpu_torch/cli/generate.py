"""Text-to-image generation with a CAT model on the card.

The port's counterpart of `favae_tpu/cli/generate.py`: CLIP text encode ->
CFG KV-cache sampling -> FA-VAE decode, written to an `.npz` (and PNGs where
PIL is installed). Weights come from reference-format `.pt` files
(`--torch_cat_ckpt`, `--favae_ckpt`, `--clip_ckpt`) or, without them, are
random from `--seed`; without `--bpe_vocab` the tokenizer is the one-merge
stub the JAX CLI falls back to.

    python -m favae_tpu_torch.cli.generate --torch_cat_ckpt CelebA_CAT.pt \
        --favae_ckpt expe_7_mu9.pt --clip_ckpt ViT-L-14.pt \
        --bpe_vocab bpe_simple_vocab_16e6.txt.gz \
        --prompt "a smiling woman with glasses" --n 4 --out samples.npz

Three engines: the exact bf16 sampler (`GPT.sample`) by default; with
`--quantized` the whole-step int8 kernel where
`ops.decode_step_kernel.supports` takes the config (`gpt2_medium`,
`gpt2_mini`), else the int8 FFN kernel with bf16 attention (`gpt2_large`).
Orbax checkpoints (`--ckpt`) are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def resolve_cfg(codebook_size: int, embed_dim: int, gpt_name: str):
    """cat_celebahq with the checkpoint-shape knobs applied: codebook size /
    embed dim feed both the quantizer and the GPT vocab; gpt_name must match
    the one the checkpoint was trained with."""
    from favae_tpu_torch import config as C

    cfg = C.cat_celebahq()
    if (codebook_size, embed_dim, gpt_name) == (1024, 256, "gpt2_medium"):
        return cfg
    gpt_factory = {"gpt2_mini": C.gpt2_mini, "gpt2_medium": C.gpt2_medium,
                   "gpt2_large": C.gpt2_large}[gpt_name]
    vqgan = dataclasses.replace(
        cfg.vqgan, quantizer=dataclasses.replace(
            cfg.vqgan.quantizer, codebook_size=codebook_size, dim=embed_dim))
    return C.CATConfig(
        vqgan=vqgan, clip=cfg.clip,
        gpt=gpt_factory(vocab_size=codebook_size,
                        n_cond_embed=cfg.gpt.n_cond_embed))


def build_parser():
    p = argparse.ArgumentParser(description="CAT text-to-image generation")
    p.add_argument("--ckpt", type=str, default=None,
                   help="favae_tpu CAT checkpoint dir (Orbax); not yet "
                        "ported to favae_tpu_torch")
    p.add_argument("--torch_cat_ckpt", type=str, default=None,
                   help="reference CelebA_CAT.pt (GPT weights)")
    p.add_argument("--favae_ckpt", type=str, default=None)
    p.add_argument("--clip_ckpt", type=str, default=None)
    p.add_argument("--bpe_vocab", type=str, default=None)
    p.add_argument("--prompt", type=str, action="append", required=True,
                   help="repeatable; one image set per prompt")
    p.add_argument("--n", type=int, default=1, help="images per prompt")
    p.add_argument("--top_k", type=int, default=500)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--cond_scale", type=float, default=3.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--quantized", action="store_true",
                   help="serve the token loop with int8 weights (faster, "
                        "slightly lossy; models/decode_engine.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="samples.npz")
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--gpt_name", type=str, default="gpt2_medium",
                   choices=["gpt2_mini", "gpt2_medium", "gpt2_large"],
                   help="must match the --gpt_name the checkpoint was "
                        "trained with")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None, cfg=None):
    """Generate; returns a dict with `images` (N, H, W, 3) in [0, 1],
    `tokens` (N, g, g), `prompts`, the stage times `clip_ms`, `prepare_ms`,
    `decode_ms`, the token loop's `first_token_ms`, `ms_per_token` (the
    mean over the other tokens), `tokens_per_s` (sampled tokens of all
    images over the loop's time), `images_per_s` (over the whole call after
    the models are built) and `route`. `cfg` replaces the CATConfig that the
    flags resolve to."""
    args = build_parser().parse_args(argv)
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt (Orbax) is not yet ported to favae_tpu_torch")
    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.convert import (load_reference_checkpoint,
                                         load_reference_clip_text,
                                         load_reference_gpt)
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu_torch.models.txt_cond import build_cat

    device = resolve_device(args.device)
    if cfg is None:
        cfg = resolve_cfg(args.codebook_size, args.embed_dim, args.gpt_name)
    tokenizer = (BPETokenizer(args.bpe_vocab) if args.bpe_vocab
                 else BPETokenizer(merges=["s y"]))
    cat = build_cat(cfg, device, seed=args.seed, tokenizer=tokenizer)
    if args.favae_ckpt:
        load_reference_checkpoint(cat.favae, args.favae_ckpt)
    if args.clip_ckpt:
        load_reference_clip_text(cat.clip, args.clip_ckpt)
    if args.torch_cat_ckpt:
        load_reference_gpt(cat.gpt, args.torch_cat_ckpt)

    prompts = [pr for pr in args.prompt for _ in range(args.n)]
    text_ids = cat.tokenize(prompts)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    timings: dict = {}
    t0 = time.perf_counter()
    imgs, grids = cat.sample_images(
        text_ids, generator=generator, top_k=args.top_k, top_p=args.top_p,
        temperature=args.temperature, cond_scale=args.cond_scale,
        quantized=args.quantized, timings=timings)
    imgs = np.clip(imgs.float().cpu().numpy() * 0.5 + 0.5, 0, 1)
    wall = time.perf_counter() - t0
    grids = grids.cpu().numpy()
    np.savez(args.out, images=imgs, tokens=grids,
             prompts=np.asarray(prompts, dtype=object))
    print(f"wrote {imgs.shape[0]} images -> {args.out}")

    # also dump pngs next to the npz when PIL is available
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        base = os.path.splitext(args.out)[0]
        for i, im in enumerate(imgs):
            Image.fromarray((im * 255).astype(np.uint8)).save(f"{base}_{i}.png")

    token_ms = timings["token_ms"]
    route, _ = cat.serving_route(len(prompts), args.quantized)
    return {
        "images": imgs, "tokens": grids, "prompts": prompts, "route": route,
        "clip_ms": timings["clip"] * 1e3,
        "prepare_ms": timings["prepare"] * 1e3,
        "decode_ms": timings["decode"] * 1e3,
        "first_token_ms": token_ms[0],
        "ms_per_token": float(np.mean(token_ms[1:])),
        "tokens_per_s": grids.size / timings["tokens"],
        "images_per_s": imgs.shape[0] / wall,
    }


if __name__ == "__main__":
    main()
