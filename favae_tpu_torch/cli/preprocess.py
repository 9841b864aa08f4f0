"""Manifest building / inspection CLI (a copy of favae_tpu/cli/preprocess.py,
over the port's own manifest builders and loader).

reference: datasets/preprocess_celeba.py (offline pkl builders) and
datasets/check_pkl_files.py (manual inspector).

    python -m favae_tpu_torch.cli.preprocess imagenet --root /data/imagenet \
        --split train --out pkl_files/imagenet_train.pkl
    python -m favae_tpu_torch.cli.preprocess celebahq --hq_root imgs \
        --mapping CelebA-HQ-to-CelebA-mapping.txt \
        --partition list_eval_partition.txt --split 0 --out celeba_train.pkl
    python -m favae_tpu_torch.cli.preprocess inspect --manifest celeba_train.pkl
"""

from __future__ import annotations

import argparse

from favae_tpu_torch.data.manifest import (build_celebahq_manifest,
                                           build_ffhq_manifest,
                                           build_imagenet_manifest,
                                           save_manifest)
from favae_tpu_torch.data.pipeline import load_manifest


def main(argv=None):
    p = argparse.ArgumentParser(description="Build/inspect pkl manifests")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("imagenet")
    pi.add_argument("--root", required=True)
    pi.add_argument("--split", default="train")
    pi.add_argument("--out", required=True)

    pf = sub.add_parser("ffhq")
    pf.add_argument("--images_root", required=True)
    pf.add_argument("--json", required=True)
    pf.add_argument("--category", default="training")
    pf.add_argument("--out", required=True)

    pc = sub.add_parser("celebahq")
    pc.add_argument("--hq_root", required=True)
    pc.add_argument("--mapping", required=True)
    pc.add_argument("--partition", required=True)
    pc.add_argument("--captions_root", default=None)
    pc.add_argument("--split", type=int, default=0,
                    help="0 train / 1 val / 2 test")
    pc.add_argument("--out", required=True)

    ps = sub.add_parser("inspect")
    ps.add_argument("--manifest", required=True)
    ps.add_argument("--n", type=int, default=5)

    args = p.parse_args(argv)
    if args.cmd == "imagenet":
        entries = build_imagenet_manifest(args.root, args.split)
    elif args.cmd == "ffhq":
        entries = build_ffhq_manifest(args.images_root, args.json, args.category)
    elif args.cmd == "celebahq":
        entries = build_celebahq_manifest(
            args.hq_root, args.mapping, args.partition,
            captions_root=args.captions_root, split=args.split)
    else:
        entries = load_manifest(args.manifest)
        print(f"{len(entries)} entries")
        for e in entries[: args.n]:
            print(" ", e)
        return

    save_manifest(entries, args.out)
    print(f"wrote {len(entries)} entries -> {args.out}")


if __name__ == "__main__":
    main()
