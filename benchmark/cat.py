"""What the CAT cells share: the configuration file read into the port's
and the reference's `CATConfig`, the seeded weights of the three models
(FA-VAE, CLIP text tower, GPT), the seeded prompts, and the reference
models.

A configuration file holds the `vqgan`, `gpt` and `clip` groups and the
CAT-level fields (`cat`) as the port's dataclasses name them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import favae
from benchmark.weights import default_rule, make_state

SOT, EOT = 49406, 49407   # CLIP's start and end of text


def cat_config(C, config: Dict):
    return C.CATConfig(vqgan=favae._vqgan(C, config["vqgan"]),
                       gpt=C.GPTConfig(**config["gpt"]),
                       clip=C.CLIPTextConfig(**config["clip"]),
                       **config["cat"])


def _rule(config: Dict):
    vq = favae.weight_rule({"model": config["vqgan"],
                            "loss": {"dsl_init_sigma": 3.0}})

    def rule(name: str, r: torch.Tensor) -> torch.Tensor:
        if name.startswith("vqgan."):
            return vq(name[len("vqgan."):], r)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "start_token"):
            return 1.0 + 0.1 * r if leaf == "gamma" else r
        return default_rule(name, r)
    return rule


def make_weights(config: Dict, seed: int, device
                 ) -> Tuple[Dict, Dict, Dict]:
    """(FA-VAE, CLIP text, GPT) state_dicts made on `device` from `seed`,
    shaped by the reference's modules on the meta device."""
    from benchmark.reference import config as RC
    from benchmark.reference.clip_text import CLIPTextEncoder
    from benchmark.reference.gpt import GPT
    from benchmark.reference.vqgan import VQGANFCM
    cfg = cat_config(RC, config)
    with torch.device("meta"):
        parts = {"vqgan": VQGANFCM(cfg.vqgan), "clip": CLIPTextEncoder(
            cfg.clip), "gpt": GPT(cfg.gpt)}
    template = {f"{k}.{n}": v for k, m in parts.items()
                for n, v in m.state_dict().items()}
    flat = make_state(template, seed, device, _rule(config))
    out = {k: {} for k in parts}
    for name, v in flat.items():
        k, n = name.split(".", 1)
        out[k][n] = v
    return out["vqgan"], out["clip"], out["gpt"]


def prompts(seed: int, count: int, lengths: Tuple[int, int], vocab: int,
            context: int) -> np.ndarray:
    """(count, context) CLIP text ids: SOT, a seeded run of ids of a
    seeded length, EOT, zeros."""
    rng = np.random.default_rng(seed)
    out = np.zeros((count, context), np.int64)
    for i in range(count):
        n = int(rng.integers(lengths[0], lengths[1] + 1))
        out[i, 0] = SOT
        out[i, 1:n + 1] = rng.integers(1, SOT, n)
        out[i, n + 1] = EOT
    return out


def reference(config: Dict, seed: int, device, fp8: bool = False):
    """The reference's FA-VAE, CLIP text tower and GPT (float32, TF32 off;
    `fp8` the control's precision in the GPT's projections and the
    FA-VAE's convolutions and products), with the seed's weights."""
    from benchmark.reference import config as RC
    from benchmark.reference.clip_text import CLIPTextEncoder
    from benchmark.reference.gpt import GPT
    from benchmark.reference.precision import use_fp8
    from benchmark.reference.vqgan import VQGANFCM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cat_config(RC, config)
    cfg = dataclasses.replace(cfg, vqgan=dataclasses.replace(
        cfg.vqgan, compute_dtype="float32"))
    vq_sd, clip_sd, gpt_sd = make_weights(config, seed, device)
    with torch.device(device):
        vq, clip, gpt = (VQGANFCM(cfg.vqgan), CLIPTextEncoder(cfg.clip),
                         GPT(cfg.gpt, dtype=torch.float32))
    # buffers made from numpy in the constructors are on the host
    vq, clip, gpt = vq.to(device), clip.to(device), gpt.to(device)
    vq.load_state_dict(vq_sd)
    clip.load_state_dict(clip_sd)
    gpt.load_state_dict(gpt_sd)
    if fp8:
        use_fp8(gpt)
        use_fp8(vq)
    return cfg, vq.eval(), clip.eval(), gpt.eval()
