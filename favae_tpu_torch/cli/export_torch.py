"""Export a favae_tpu_torch checkpoint to a reference-format `.pt`.

The port's counterpart of `favae_tpu/cli/export_torch.py`, with its flags:
train on the card, hand the weights to the reference ecosystem (and to
the port's own `--torch_ckpt` / `--torch_cat_ckpt`).

    python -m favae_tpu_torch.cli.export_torch --preset celebahq_expe5 \\
        --orbax_ckpt output/run/best --out run_best.pt

    python -m favae_tpu_torch.cli.export_torch --cat \\
        --orbax_ckpt output/cat/run/best --gpt_name gpt2_medium \\
        --codebook_size 1024 --out cat_best.pt

`--orbax_ckpt` names a port checkpoint directory (`latest` / `best`); an
Orbax checkpoint of favae_tpu raises, naming the route from one. The
checkpoint's weights are checked against the configuration the flags
give (names and shapes) before anything is written. `--resolution` and
`--adam_mu_dtype` are accepted as the JAX CLI's: they shape its Orbax
restore template, and a torch load needs none. Runs on the CPU.
"""

from __future__ import annotations

import argparse

import torch


def build_parser():
    p = argparse.ArgumentParser(description="Export checkpoint to torch .pt")
    p.add_argument("--preset", type=str, default="celebahq_expe5")
    p.add_argument("--orbax_ckpt", type=str, required=True,
                   help="favae_tpu_torch checkpoint dir (latest/best)")
    p.add_argument("--out", type=str, required=True, help="output .pt path")
    p.add_argument("--resolution", type=int, default=256,
                   help="accepted for the JAX CLI's flag surface")
    p.add_argument("--cat", action="store_true",
                   help="export a CAT GPT checkpoint instead of FA-VAE")
    p.add_argument("--gpt_name", type=str, default="gpt2_medium",
                   choices=["gpt2_mini", "gpt2_medium", "gpt2_large"])
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--n_cond_embed", type=int, default=768)
    p.add_argument("--adam_mu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="accepted for the JAX CLI's flag surface; a torch "
                        "checkpoint needs no restore template")
    return p


def _check_layout(module_factory, sd) -> None:
    """Load `sd` strictly into the module that `module_factory` builds on
    the meta device: the names and shapes must be the configuration's."""
    with torch.device("meta"):
        module = module_factory()
    module.load_state_dict(sd, strict=True, assign=True)


def main(argv=None, cfg=None):
    """Export; returns the path written. `cfg` replaces the configuration
    the flags resolve to (a VQGANConfig, or with `--cat` a GPTConfig)."""
    args = build_parser().parse_args(argv)
    from favae_tpu_torch import config as C
    from favae_tpu_torch.utils.checkpoint import restore_checkpoint
    from favae_tpu_torch.utils.torch_export import save_cat_pt, save_favae_pt

    state, meta = restore_checkpoint(args.orbax_ckpt, "cpu")
    epoch = int(meta.get("epoch", 0))
    if args.cat:
        from favae_tpu_torch.models.gpt import GPT
        gpt_cfg = cfg or {"gpt2_mini": C.gpt2_mini,
                          "gpt2_medium": C.gpt2_medium,
                          "gpt2_large": C.gpt2_large}[args.gpt_name](
            vocab_size=args.codebook_size, n_cond_embed=args.n_cond_embed)
        _check_layout(lambda: GPT(gpt_cfg), state["gpt"])
        save_cat_pt(args.out, state["gpt"],
                    image_encoded_dim=gpt_cfg.image_encoded_dim,
                    n_cond_embed=gpt_cfg.n_cond_embed, epoch=epoch,
                    best_score=float(meta.get("best_score",
                                              meta.get("score", "inf"))),
                    step=int(state["step"]))
        print(f"wrote reference-format CAT checkpoint -> {args.out}")
        return args.out
    from favae_tpu_torch.models.vqgan import VQGANFCM
    if args.preset not in C.PRESETS or args.preset == "cat_celebahq":
        raise SystemExit(f"unknown preset '{args.preset}'")
    model_cfg = cfg or C.PRESETS[args.preset]()
    _check_layout(lambda: VQGANFCM(model_cfg), state["model"])
    save_favae_pt(args.out, state["model"], epoch=epoch,
                  step=int(state["step"]))
    print(f"wrote reference-format checkpoint -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
