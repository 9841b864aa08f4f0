"""VQGAN with Frequency Complement Modules, the FA-VAE model (port of
favae_tpu/models/vqgan.py): encoder, quantizer, decoder and discriminator,
with the DSL sigma topology (non-pairwise sigmas live in the encoder and
decoder, pairwise ones here).

Public methods take and return NHWC tensors like the JAX package (images in
[-1, 1]); inside, activations are NCHW in channels_last, so the conversion at
the boundary is a view. As in the JAX package the train step calls
`generate` and `discriminate` separately, to split the loss heads at the
reconstruction (see favae_tpu_torch.train.favae_step).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from favae_tpu_torch import resolve_device
from favae_tpu_torch.config import DSL_NONPAIR, DSL_PAIR, VQGANConfig
from favae_tpu_torch.models.codec import Decoder, Encoder
from favae_tpu_torch.models.discriminator import (build_discriminator,
                                                  init_discriminator_)
from favae_tpu_torch.models.quantizer import (CodebookState, VectorQuantize,
                                              init_codebook_state)
from favae_tpu_torch.ops.gaussian import gaussian_blur_nhwc


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VQGANFCM(nn.Module):
    def __init__(self, cfg: VQGANConfig, gaussian_kernel: int = 9,
                 dsl_init_sigma: float = 3.0):
        super().__init__()
        self.cfg = cfg
        self.gaussian_kernel = gaussian_kernel
        dtype = getattr(torch, cfg.compute_dtype)
        nonpair = cfg.dsl_mode == DSL_NONPAIR
        self.encoder = Encoder(cfg.codec, dsl_nonpair=nonpair,
                               dsl_init_sigma=dsl_init_sigma, dtype=dtype,
                               gaussian_kernel=gaussian_kernel)
        self.decoder = Decoder(cfg.codec, fcm_kind=cfg.fcm_kind,
                               dsl_nonpair=nonpair,
                               dsl_init_sigma=dsl_init_sigma, dtype=dtype,
                               gaussian_kernel=gaussian_kernel)
        self.quantizer = VectorQuantize(cfg.quantizer)
        self.discriminator = build_discriminator(cfg.discriminator, dtype)
        if cfg.dsl_mode == DSL_PAIR:
            self.sigmas = nn.Parameter(torch.full((4,), dsl_init_sigma))

    def codebook_state(self) -> CodebookState:
        return self.quantizer.state()

    def encode(self, x, cb_state: Optional[CodebookState] = None):
        """x (B, H, W, 3) in [-1, 1] -> (z_q (B, h, w, dim) f32,
        indices (B, h, w) int64, 4 encoder taps NHWC)
        (reference: models/vqgan_fcm.py:112-118)."""
        z, taps = self.encoder(_nchw(x))
        z_q, idx, _, _ = self.quantizer(z, cb_state)
        return _nhwc(z_q), idx, [_nhwc(t) for t in taps]

    def decode(self, z):
        """z (B, h, w, dim) -> (x_recon (B, H, W, 3) f32, 4 decoder taps,
        h_pre), all NHWC (reference: models/vqgan_fcm.py:120-122)."""
        x, taps, h_pre = self.decoder(_nchw(z))
        return _nhwc(x), [_nhwc(t) for t in taps], _nhwc(h_pre)

    def generate(self, x, cb_state: Optional[CodebookState] = None, *,
                 train: bool = False, inference: bool = False):
        """The generator's stage-0 body: encode -> quantize -> decode, taps
        blurred unless `inference` (non-pairwise in the codec, pairwise here
        when also `train`), the quantizer EMA-updating when `train`
        (favae_tpu/models/vqgan.py:110-124). Returns a dict of x_recon,
        enc_feats, dec_feats, h_pre (NHWC), loss_q, indices and cb_state,
        the new codebook state (the module's buffers are not written)."""
        z, enc = self.encoder(_nchw(x), blur=not inference)
        z_q, idx, loss_q, state = self.quantizer(z, cb_state, train=train)
        x_rec, dec, h_pre = self.decoder(z_q, blur=not inference)
        enc, dec = [_nhwc(t) for t in enc], [_nhwc(t) for t in dec]
        if self.cfg.dsl_mode == DSL_PAIR and train and not inference:
            enc, dec = self.blur_taps_pairwise(enc, dec)
        return dict(x_recon=_nhwc(x_rec), enc_feats=enc, dec_feats=dec,
                    h_pre=_nhwc(h_pre), loss_q=loss_q, indices=idx,
                    cb_state=state)

    def blur_taps_pairwise(self, enc_feats, dec_feats):
        """Pairwise DSL: encoder tap i and decoder tap j blurred with the
        shared sigmas i and j (favae_tpu/models/vqgan.py:99-108)."""
        assert self.cfg.dsl_mode == DSL_PAIR
        k = self.gaussian_kernel
        return ([gaussian_blur_nhwc(f, k, self.sigmas[i])
                 for i, f in enumerate(enc_feats)],
                [gaussian_blur_nhwc(f, k, self.sigmas[j])
                 for j, f in enumerate(dec_feats)])

    def discriminate(self, x):
        """Image (B, H, W, 3) -> NHWC f32 logits; BatchNorm on batch
        statistics (updating the running ones) in train mode."""
        return _nhwc(self.discriminator(_nchw(x)))

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


def build_model(cfg: VQGANConfig, device=None, seed: int = 0,
                gaussian_kernel: int = 9,
                dsl_init_sigma: float = 3.0) -> VQGANFCM:
    """A VQGANFCM in eval mode with random weights made from `seed` (PyTorch's
    default initialisers, the pix2pix discriminator init, a kaiming-uniform
    codebook), on `device`: CUDA unless the caller names another."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VQGANFCM(cfg, gaussian_kernel, dsl_init_sigma)
    gen = torch.Generator().manual_seed(seed)
    model.quantizer.set_state(init_codebook_state(cfg.quantizer, gen))
    init_discriminator_(model.discriminator, gen)
    return model.to(dev).eval()
