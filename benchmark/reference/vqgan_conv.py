"""The FA-VAE model of the port's `models/vqgan.py` for the configurations
with the FCM(conv) decoder and a projected codebook (`imagenet_f4`), the
benchmark's reference (imports nothing of the port; see ../README.md).

`vqgan.VQGANFCM`'s methods over other parts: `codec.Encoder`,
`codec_conv.Decoder` and `quantizer_proj.VectorQuantize`, with the
discriminator and the pairwise sigmas that the port's model holds, so
that one state_dict loads into both. Departures from
`favae_tpu_torch/models/vqgan.py`: reconstruction and decoding only (the
quantizer does not train, the decoder does not blur its taps); non-pairwise
sigmas are not carried.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import vqgan
from benchmark.reference.codec import Encoder
from benchmark.reference.codec_conv import Decoder
from benchmark.reference.config import DSL_PAIR, VQGANConfig
from benchmark.reference.discriminator import build_discriminator
from benchmark.reference.quantizer_proj import VectorQuantize


class VQGANFCMConv(vqgan.VQGANFCM):
    def __init__(self, cfg: VQGANConfig, gaussian_kernel: int = 9,
                 dsl_init_sigma: float = 3.0):
        nn.Module.__init__(self)
        if cfg.dsl_mode != DSL_PAIR:
            raise NotImplementedError(
                "the conv-FCM reference model carries dsl_mode 'pair' only, "
                f"not {cfg.dsl_mode!r}")
        self.cfg = cfg
        self.gaussian_kernel = gaussian_kernel
        dtype = getattr(torch, cfg.compute_dtype)
        self.encoder = Encoder(cfg.codec, dtype=dtype,
                               gaussian_kernel=gaussian_kernel)
        self.decoder = Decoder(cfg.codec, fcm_kind=cfg.fcm_kind, dtype=dtype)
        self.quantizer = VectorQuantize(cfg.quantizer)
        self.discriminator = build_discriminator(cfg.discriminator, dtype)
        self.sigmas = nn.Parameter(torch.full((4,), dsl_init_sigma))
