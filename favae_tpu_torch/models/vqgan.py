"""VQGAN with Frequency Complement Modules, the FA-VAE model (port of
favae_tpu/models/vqgan.py, inference path: no discriminator, no tap blur).

Public methods take and return NHWC tensors like the JAX package (images in
[-1, 1]); inside, activations are NCHW in channels_last, so the conversion at
the boundary is a view.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import DSL_NONPAIR, DSL_PAIR, VQGANConfig
from favae_tpu_torch.models.codec import Decoder, Encoder
from favae_tpu_torch.models.quantizer import (CodebookState, VectorQuantize,
                                              init_codebook_state)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VQGANFCM(nn.Module):
    def __init__(self, cfg: VQGANConfig, dsl_init_sigma: float = 3.0):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        nonpair = cfg.dsl_mode == DSL_NONPAIR
        self.encoder = Encoder(cfg.codec, dsl_nonpair=nonpair,
                               dsl_init_sigma=dsl_init_sigma, dtype=dtype)
        self.decoder = Decoder(cfg.codec, fcm_kind=cfg.fcm_kind,
                               dsl_nonpair=nonpair,
                               dsl_init_sigma=dsl_init_sigma, dtype=dtype)
        self.quantizer = VectorQuantize(cfg.quantizer)
        if cfg.dsl_mode == DSL_PAIR:
            self.sigmas = nn.Parameter(torch.full((4,), dsl_init_sigma))

    def codebook_state(self) -> CodebookState:
        return self.quantizer.state()

    def encode(self, x, cb_state: Optional[CodebookState] = None):
        """x (B, H, W, 3) in [-1, 1] -> (z_q (B, h, w, dim) f32,
        indices (B, h, w) int64, 4 encoder taps NHWC)
        (reference: models/vqgan_fcm.py:112-118)."""
        z, taps = self.encoder(_nchw(x))
        z_q, idx = self.quantizer(z, cb_state)
        return _nhwc(z_q), idx, [_nhwc(t) for t in taps]

    def decode(self, z):
        """z (B, h, w, dim) -> (x_recon (B, H, W, 3) f32, 4 decoder taps,
        h_pre), all NHWC (reference: models/vqgan_fcm.py:120-122)."""
        x, taps, h_pre = self.decoder(_nchw(z))
        return _nhwc(x), [_nhwc(t) for t in taps], _nhwc(h_pre)

    @torch.inference_mode()
    def decode_code(self, indices, cb_state: Optional[CodebookState] = None):
        """Token grid (B, h, w) -> image (B, H, W, 3)
        (reference: models/txt_cond_transformer.py:160-168)."""
        x, _, _ = self.decoder(self.quantizer.decode_indices(indices, cb_state))
        return _nhwc(x)

    @torch.inference_mode()
    def reconstruct(self, x, cb_state: Optional[CodebookState] = None):
        """encode -> quantize -> decode: (x_recon NHWC f32, indices)."""
        z_q, idx, _ = self.encode(x, cb_state)
        x_recon, _, _ = self.decode(z_q)
        return x_recon, idx


def build_model(cfg: VQGANConfig, device=None, seed: int = 0) -> VQGANFCM:
    """A VQGANFCM in eval mode with random weights made from `seed` (PyTorch's
    default initialisers, a kaiming-uniform codebook), on `device`: CUDA
    unless the caller names another."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VQGANFCM(cfg)
    gen = torch.Generator().manual_seed(seed)
    model.quantizer.set_state(init_codebook_state(cfg.quantizer, gen))
    return model.to(dev).eval()
