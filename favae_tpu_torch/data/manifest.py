"""Offline manifest builders: pkl files that the data pipeline reads (a
copy of favae_tpu/data/manifest.py, which imports no JAX; the port keeps
its own).

reference: datasets/preprocess_celeba.py:17-152 — builds pickled lists for
CelebA-HQ (with captions merged from the CelebA mapping + eval partition),
FFHQ (json categories) and ImageNet (directory glob). Re-implemented with the
same output formats:

* FA-VAE manifests: list[str] of image paths;
* CAT manifests: list[[path, caption]].
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def save_manifest(entries: List, out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(entries, f)


def build_imagenet_manifest(root: str, split: str = "train") -> List[str]:
    """Directory-glob manifest (reference: preprocess_celeba.py:104-133)."""
    base = os.path.join(root, split)
    out: List[str] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(base)):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, fn))
    return out


def build_ffhq_manifest(images_root: str, json_path: str,
                        category: str = "training") -> List[str]:
    """FFHQ manifest from the dataset's json category file
    (reference: preprocess_celeba.py:73-101)."""
    with open(json_path) as f:
        meta = json.load(f)
    out = []
    for _k, v in sorted(meta.items()):
        if v.get("category") == category:
            out.append(os.path.join(images_root, v["image"]["file_path"]))
    return out


def build_celebahq_manifest(
    hq_images_root: str,
    mapping_txt: str,
    eval_partition_txt: str,
    captions_root: Optional[str] = None,
    split: int = 0,
) -> List:
    """CelebA-HQ manifest (reference: preprocess_celeba.py:17-70).

    Joins CelebA-HQ-to-CelebA-mapping.txt with list_eval_partition.txt to
    assign each HQ image its CelebA split (0 train / 1 val / 2 test). With
    `captions_root` (CelebA-Dialog style: one .txt of caption lines per
    image), emits [path, caption] per caption line; otherwise plain paths.
    """
    # orig CelebA filename -> split
    part: Dict[str, int] = {}
    with open(eval_partition_txt) as f:
        for line in f:
            name, sp = line.split()
            part[name] = int(sp)

    out: List = []
    with open(mapping_txt) as f:
        header = f.readline()  # idx  orig_idx  orig_file
        for line in f:
            cols = line.split()
            if len(cols) < 3:
                continue
            hq_idx, _orig_idx, orig_file = cols[0], cols[1], cols[2]
            if part.get(orig_file) != split:
                continue
            img_path = os.path.join(hq_images_root, f"{int(hq_idx)}.jpg")
            if captions_root is None:
                out.append(img_path)
            else:
                cap_file = os.path.join(
                    captions_root, os.path.splitext(orig_file)[0] + ".txt")
                if not os.path.exists(cap_file):
                    continue
                with open(cap_file) as cf:
                    for cap in cf:
                        cap = cap.strip()
                        if cap:
                            out.append([img_path, cap])
    return out
