"""CAT composition: frozen FA-VAE + frozen CLIP text encoder + GPT (port of
favae_tpu/models/txt_cond.py; reference: models/txt_cond_transformer.py:
29-265). Ported for serving: text -> tokens -> image. The teacher-forced
losses (`gpt_loss*`) belong to CAT training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import CATConfig
from favae_tpu_torch.models.clip_text import (BPETokenizer, CLIPTextEncoder,
                                              tokenize)
from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                  sample_tokens)
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.models.vqgan import VQGANFCM, build_model
from favae_tpu_torch.ops.decode_step_kernel import (prepare_fused_decode,
                                                    supports)


@dataclasses.dataclass
class CATModel:
    cfg: CATConfig
    favae: VQGANFCM
    clip: CLIPTextEncoder
    gpt: GPT
    tokenizer: Optional[BPETokenizer] = None

    @property
    def device(self) -> torch.device:
        return self.gpt.start_token.device

    @torch.inference_mode()
    def encode_to_z(self, x):
        """Frozen FA-VAE encode -> token ids (B, L)
        (reference: txt_cond_transformer.py:134-139)."""
        _, indices, _ = self.favae.encode(x)
        return indices.reshape(indices.shape[0], -1)

    @torch.inference_mode()
    def encode_text_ids(self, text_ids):
        """CLIP text ids -> (token embeds (B, 77, D) f32, mask (B, 77))
        (reference: txt_cond_transformer.py:142-150: mask = ids > 0;
        optional L2 normalisation)."""
        embeds, _ = self.clip(text_ids)
        embeds = embeds.float()
        if self.cfg.normalize_clip:
            embeds = embeds / torch.linalg.norm(embeds, dim=-1, keepdim=True)
        return embeds, text_ids > 0

    def tokenize(self, texts) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("no BPE merges file configured")
        ids = tokenize(self.tokenizer, texts, self.cfg.clip.context_length)
        return torch.from_numpy(ids).long().to(self.device)

    def decode_to_img(self, index_grid):
        """Sampled (B, g, g) token grid -> image
        (reference: txt_cond_transformer.py:160-168)."""
        return self.favae.decode_code(index_grid)

    def serving_route(self, b: int, quantized: bool):
        """(engine, batch it runs at) of `sample_images` for `b` prompts:
        "exact"; or, quantized, "fused" (the whole-step kernel, the batch
        padded to a multiple of 4) where `supports` takes the config at the
        padded batch's 2B CFG rows, else "ffn_int8" at the batch as given."""
        if not quantized:
            return "exact", b
        b_pad = max(4, -(-b // 4) * 4)
        if supports(self.cfg.gpt, 2 * b_pad):
            return "fused", b_pad
        return "ffn_int8", b

    @torch.inference_mode()
    def sample_images(self, text_ids, *,
                      generator: Optional[torch.Generator] = None,
                      top_k: Optional[int] = None, top_p: float = 1.0,
                      temperature: float = 1.0,
                      cond_scale: Optional[float] = None,
                      quantized: bool = False,
                      gumbel_noise: Optional[torch.Tensor] = None,
                      timings: Optional[dict] = None):
        """Text -> (images (B, H, W, 3), token grid (B, g, g)) (reference:
        txt_cond_transformer.py:171-185): CLIP encode, CFG KV-cache
        sampling, FA-VAE decode.

        `quantized=True` routes the token loop through the int8 serving
        engine (models/decode_engine.py): the whole-step kernel where
        `supports` says it takes the config, with the prompt batch padded to
        a multiple of 4 so that the 2B CFG rows are a multiple of 8 (the
        padding rows repeat the first prompt and are cut from the result),
        else the int8 FFN kernel with bf16 attention. `gumbel_noise`
        (S, B', vocab), B' the padded batch, replaces the generator's draws.
        `timings`, if given, receives the seconds of the stages ("clip",
        "prepare", "tokens", "decode") and "token_ms", the time of each
        token of the loop: device time between CUDA events on a card, host
        time on the CPU."""
        cs = self.cfg.cond_scale if cond_scale is None else cond_scale
        mark = _Marks(self.device, timings is not None)
        mark("start")
        embeds, mask = self.encode_text_ids(text_ids)
        mark("clip")
        b = text_ids.shape[0]
        kw = dict(generator=generator, temperature=temperature, top_k=top_k,
                  top_p=top_p, cond_scale=cs, gumbel_noise=gumbel_noise,
                  on_token=lambda pos: mark("token"))
        if quantized:
            route, b_pad = self.serving_route(b, quantized)
            if route == "fused":
                if b_pad != b:
                    embeds = torch.cat(
                        [embeds, embeds[:1].expand(b_pad - b, -1, -1)], 0)
                    mask = torch.cat(
                        [mask, mask[:1].expand(b_pad - b, -1)], 0)
                kw["fused"] = prepare_fused_decode(self.gpt, self.cfg.gpt)
            else:
                kw["qparams"] = quantize_decode_params(self.gpt)
            mark("prepare")
            grid = sample_tokens(self.cfg.gpt, self.gpt, embeds, mask,
                                 dtype=self.gpt.dtype, **kw)[:b]
        else:
            mark("prepare")
            grid = self.gpt.sample(embeds, mask, **kw)
        mark("tokens")
        imgs = self.favae.decode_code(grid)
        mark("decode")
        if timings is not None:
            timings.update(mark.report())
        return imgs, grid


class _Marks:
    """Named time marks: CUDA events on a card, host times on the CPU.
    `report` gives the seconds from each mark's predecessor to it, by name,
    with the "token" marks gathered into `token_ms`."""

    def __init__(self, device: torch.device, enabled: bool):
        self.cuda, self.enabled = device.type == "cuda", enabled
        self.marks = []

    def __call__(self, name: str) -> None:
        if not self.enabled:
            return
        if self.cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
        else:
            now = time.perf_counter()
        self.marks.append((name, now))

    def report(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {"token_ms": []}
        for (_, t0), (name, t1) in zip(self.marks, self.marks[1:]):
            ms = t0.elapsed_time(t1) if self.cuda else (t1 - t0) * 1e3
            if name == "token":
                out["token_ms"].append(ms)
            elif name == "tokens":  # the loop's end: the whole loop's time
                out[name] = sum(out["token_ms"]) / 1e3 + ms / 1e3
            else:
                out[name] = ms / 1e3
        return out


def build_cat(cfg: CATConfig, device=None, seed: int = 0,
              tokenizer: Optional[BPETokenizer] = None) -> CATModel:
    """A CATModel in eval mode with random weights made from `seed`
    (PyTorch's default initialisers), on `device`: CUDA unless the caller
    names another. Load converted or reference weights into `.favae`,
    `.clip` and `.gpt` afterwards."""
    dev = resolve_device(device)
    favae = build_model(cfg.vqgan, dev, seed=seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        clip = CLIPTextEncoder(cfg.clip)
        gpt = GPT(cfg.gpt)
    return CATModel(cfg=cfg, favae=favae, clip=clip.to(dev).eval(),
                    gpt=gpt.to(dev).eval(), tokenizer=tokenizer)
