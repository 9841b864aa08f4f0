"""CAT composition: frozen FA-VAE + frozen CLIP text encoder + GPT (port of
favae_tpu/models/txt_cond.py; reference: models/txt_cond_transformer.py:
29-265). Serving: text -> tokens -> image (`sample_images`, in inference
mode). Training: the teacher-forced CE (`gpt_loss`, and
`gpt_loss_from_latents` over cached frozen-tower outputs); the frozen towers
run without a graph (`torch.no_grad`, their parameters frozen), so their
outputs can enter a training graph. `sample_images`' stages run inside the
spans `cat.clip`, `cat.prepare`, `cat.tokens` and `cat.decode`
(`profiling.span`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.nn.functional as F

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import CATConfig
from favae_tpu_torch.models.clip_text import (BPETokenizer, CLIPTextEncoder,
                                              tokenize)
from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                  sample_tokens)
from favae_tpu_torch.models import serving_plan
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.models.vqgan import VQGANFCM, build_model
from favae_tpu_torch.ops.decode_step_kernel import (prepare_fused_decode,
                                                    supports)
from favae_tpu_torch.profiling import span


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

    @torch.no_grad()
    def encode_to_z(self, x):
        """Frozen FA-VAE encode -> token ids (B, L)
        (reference: txt_cond_transformer.py:134-139)."""
        _, indices, _ = self.favae.encode(x)
        return indices.reshape(indices.shape[0], -1)

    @torch.no_grad()
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

    def gpt_loss(self, x, text_ids, *, train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 cond_keep: Optional[torch.Tensor] = None):
        """Teacher-forced CE of the GPT over the frozen encodes of images x
        (B, H, W, 3) in [-1, 1] and CLIP text ids (reference:
        txt_cond_transformer.py:112-125; favae_tpu txt_cond.py:86-97)."""
        z = self.encode_to_z(x)
        embeds, mask = self.encode_text_ids(text_ids)
        return self.gpt_loss_from_latents(z, embeds, mask, train=train,
                                          generator=generator,
                                          cond_keep=cond_keep)

    def gpt_loss_from_latents(self, z, embeds, mask, *, train: bool = True,
                              generator: Optional[torch.Generator] = None,
                              cond_keep: Optional[torch.Tensor] = None):
        """`gpt_loss` from the frozen towers' outputs: token ids z (B, L),
        CLIP token embeds and mask. The input is z[:, :-1] (the GPT puts
        its start token first); the CE in f32 is over all L positions
        against z. Training draws dropout and conditioning dropout from
        `generator` (`cond_keep` (B,) bool replaces the latter); the eval
        loss is deterministic unless `cfg.eval_cond_drop`
        (favae_tpu txt_cond.py:99-134)."""
        drop = (self.cfg.gpt.cond_drop_prob
                if (train or self.cfg.eval_cond_drop) else 0.0)
        logits = self.gpt(z[:, :-1], embeds, mask, cond_drop_prob=drop,
                          train=train, generator=generator,
                          cond_keep=cond_keep)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               z.reshape(-1))

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

        The token loop is `sample_tokens` (models/decode_engine.py), kept
        by the GPT's serving plans across calls (`models/serving_plan.py`,
        `drop_plans`): its exact route, `GPT.sample`'s, or with
        `quantized=True` an int8 one:
        the whole-step kernel where `supports` says it takes the config,
        with the prompt batch padded to a multiple of 4 so that the 2B CFG
        rows are a multiple of 8 (the padding rows repeat the first prompt
        and are cut from the result), else the int8 FFN kernel with bf16
        attention. `gumbel_noise`
        (S, B', vocab), B' the padded batch, replaces the generator's draws.
        `timings`, if given, receives the seconds of the stages ("clip",
        "prepare", "tokens", "decode") and "token_ms", the time of each
        token of the loop: device time between CUDA events on a card, host
        time on the CPU."""
        cs = self.cfg.cond_scale if cond_scale is None else cond_scale
        mark = _Marks(self.device, timings is not None)
        mark("start")
        with span("cat.clip"):
            embeds, mask = self.encode_text_ids(text_ids)
        mark("clip")
        b = text_ids.shape[0]
        kw = dict(generator=generator, temperature=temperature, top_k=top_k,
                  top_p=top_p, cond_scale=cs, gumbel_noise=gumbel_noise,
                  on_token=lambda pos: mark("token"))
        with span("cat.prepare"):
            if quantized:
                route, b_pad = self.serving_route(b, quantized)
                if route == "fused":
                    if b_pad != b:
                        embeds = torch.cat(
                            [embeds, embeds[:1].expand(b_pad - b, -1, -1)], 0)
                        mask = torch.cat(
                            [mask, mask[:1].expand(b_pad - b, -1)], 0)
                    kw["fused"] = self._prepared(
                        "fused", lambda: prepare_fused_decode(
                            self.gpt, self.cfg.gpt), gumbel_noise)
                else:
                    kw["qparams"] = self._prepared(
                        "qparams", lambda: quantize_decode_params(self.gpt),
                        gumbel_noise)
        mark("prepare")
        with span("cat.tokens"):
            grid = sample_tokens(self.cfg.gpt, self.gpt, embeds, mask,
                                 **kw)[:b]
        mark("tokens")
        with span("cat.decode"):
            imgs = self.favae.decode_code(grid)
        mark("decode")
        if timings is not None:
            timings.update(mark.report())
        return imgs, grid


    def _prepared(self, name: str, make, gumbel_noise) -> dict:
        """An int8 route's prepared weights: the ones the GPT's serving
        plans keep (made once after each change of its parameters), or made
        anew for a call with `gumbel_noise`, which runs without a plan."""
        if gumbel_noise is not None:
            return make()
        return serving_plan.weights(self.gpt, name, make)

    def drop_plans(self) -> None:
        """Free the GPT's serving plans and the weights they keep
        (`models/serving_plan.py`), as a trainer does after a preview: the
        steps between two previews change the GPT, so the next preview
        builds anew, and the plans would hold ~1.2 GB of casts at
        gpt2_medium through the training."""
        serving_plan.drop(self.gpt)


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
    names another, the FA-VAE and CLIP frozen. Load converted or reference
    weights into `.favae`, `.clip` and `.gpt` afterwards."""
    dev = resolve_device(device)
    favae = build_model(cfg.vqgan, dev, seed=seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        clip = CLIPTextEncoder(cfg.clip)
        gpt = GPT(cfg.gpt)
    favae.requires_grad_(False)
    clip.requires_grad_(False)
    return CATModel(cfg=cfg, favae=favae, clip=clip.to(dev).eval(),
                    gpt=gpt.to(dev).eval(), tokenizer=tokenizer)
