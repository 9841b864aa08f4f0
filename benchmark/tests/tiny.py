"""Tiny cells for the CPU tests: each configuration file cut to widths a
CPU runs in seconds, each traffic file to a few small images, run through
the drivers on the CPU (the harness's look for a card skipped)."""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from benchmark.harness import Cell, Context, load_json, BENCH


def tiny_expe5() -> dict:
    cfg = copy.deepcopy(load_json(BENCH / "configs" / "celebahq_expe5.json"))
    m = cfg["model"]
    m["codec"].update(base_channels=32, ch_mult=[1, 2], num_res_blocks=1,
                      attn_resolutions=[16], resolution=32, z_channels=32)
    # the configuration's 1024 codes: their near-ties are what the control's
    # precision flips
    m["quantizer"].update(dim=32)
    m["discriminator"].update(base_channels=8, num_layers=2)
    m["compute_dtype"] = "float32"
    cfg["loss"]["spectral_dtype"] = "float32"
    cfg["train"]["batch_size"] = 2
    return cfg


# the cached CAT training cell waits for a later change (PERF.md, Open
# questions); its driver is tested with this mix
CAT_TRAIN_CACHED = {
    "driver": "cat_train", "images": 8, "image_size": 64, "batch": 2,
    "loader_threads": 2, "cached": True, "first_steps": 3, "warmup_steps": 2,
    "print_steps": 10, "img_steps": 0, "trace_seconds": 1,
    "limits": {"loss_gap": 0.01, "change_gap": 0.3}}


def tiny_cell(name: str, config: dict, traffic_name: str,
              **traffic_overrides) -> Cell:
    traffic = (dict(CAT_TRAIN_CACHED) if traffic_name == "cat-train-cached"
               else load_json(BENCH / "traffic" / f"{traffic_name}.json"))
    traffic.update(images=8, image_size=64, resolution=32, loader_threads=2,
                   trace_seconds=1)
    traffic.update(traffic_overrides)
    entry = {"name": name, "config": config["name"], "traffic": traffic_name,
             "chips": 1}
    bench = load_json(BENCH.parent / "BENCHMARK.json")
    return Cell(name, entry, config, traffic, bench)


class _AtLeast(Context):
    """A context whose window is not due before `min_items` work items
    have asked (`due` is asked once before each)."""

    def __init__(self, *args, min_items: int = 0):
        super().__init__(*args)
        self.asked, self.min_items = 0, min_items

    @property
    def due(self) -> bool:
        self.asked += 1
        return self.asked > self.min_items and super().due


def context(cell: Cell, seed: int, tmp: Path, seconds: float = 1.0,
            min_items: int = 0):
    torch.manual_seed(0)
    return _AtLeast(cell, seed, torch.device("cpu"), seconds, None, tmp,
                    min_items=min_items)


def tiny_cat() -> dict:
    cfg = copy.deepcopy(load_json(BENCH / "configs" / "cat_celebahq.json"))
    cfg["vqgan"]["codec"].update(base_channels=32, ch_mult=[1, 2],
                                 num_res_blocks=1, attn_resolutions=[],
                                 resolution=16, z_channels=32)
    cfg["vqgan"]["quantizer"].update(codebook_size=64, dim=32)
    cfg["vqgan"]["discriminator"].update(base_channels=8, num_layers=2)
    cfg["vqgan"]["compute_dtype"] = "float32"
    cfg["gpt"].update(vocab_size=64, n_layer=2, n_embed=64, n_head=2,
                      dim_head=32, image_encoded_dim=8, n_cond_embed=32)
    cfg["clip"].update(width=32, heads=2, layers=2, embed_dim=32)
    return cfg
