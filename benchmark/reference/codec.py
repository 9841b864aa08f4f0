"""Frozen copy of the port's `models/codec.py` cut to what the benchmark's
configurations run, the benchmark's reference (imports nothing of the
port; see ../README.md).

Encoder and Decoder with Frequency Complement Modules (port of
favae_tpu/models/codec.py), the decoder's FCMs the `res` flavour (a
ResnetBlock applied inline); the `none`, `conv` and `attn` flavours are
not carried and raise. Under `dsl_nonpair` each side holds its 4 learned
`sigmas`. With
`blur=True` (the train step's stage-0 forward; favae_tpu codec.py:63,149
blur whenever not `inference`) each tap i is Gaussian-blurred with sigma i,
differentiably in the sigmas; otherwise the taps come out raw.

Both return the result plus 4 feature taps: encoder after conv_in, after the
down stack, after mid, after final; decoder the 4 FCM outputs (the stage
Tensors are NCHW, channels_last.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.config import CodecConfig, FCM_RES
from benchmark.reference.blocks import (AttnBlock, Downsample, GroupNormAct,
                                        ResnetBlock, Upsample, conv1x1,
                                        conv3x3)
from benchmark.reference.gaussian import gaussian_blur


def _sigmas(init: float) -> nn.Parameter:
    return nn.Parameter(torch.full((4,), init))


class _Taps:
    """Collects the 4 taps, blurring tap i with sigmas[i] when asked."""

    def __init__(self, module: nn.Module, blur: bool):
        self.taps = []
        self.sigmas = getattr(module, "sigmas", None) if blur else None
        self.kernel = getattr(module, "gaussian_kernel", 0)

    def append(self, h):
        if self.sigmas is not None:
            h = gaussian_blur(h, self.kernel, self.sigmas[len(self.taps)])
        self.taps.append(h)


class Encoder(nn.Module):
    """Taming-style encoder returning (z, 4 taps)
    (reference: models/codec.py:125-314)."""

    def __init__(self, cfg: CodecConfig, dsl_nonpair: bool = False,
                 dsl_init_sigma: float = 3.0, dtype=torch.bfloat16,
                 gaussian_kernel: int = 9):
        super().__init__()
        self.dtype = dtype
        self.gaussian_kernel = gaussian_kernel
        drop = cfg.dropout
        base = cfg.base_channels
        self.conv_in = conv3x3(cfg.in_channels, base, dtype)
        self.down = nn.ModuleList()
        ch, res = base, cfg.resolution
        for level, mult in enumerate(cfg.ch_mult):
            out = base * mult
            for _ in range(cfg.num_res_blocks):
                self.down.append(ResnetBlock(ch, out, dtype=dtype,
                                             dropout=drop))
                ch = out
                if res in cfg.attn_resolutions:
                    self.down.append(AttnBlock(ch, dtype=dtype))
            if level != len(cfg.ch_mult) - 1:
                self.down.append(Downsample(ch, dtype))
                res //= 2
        self.mid = nn.ModuleList([ResnetBlock(ch, ch, dtype=dtype,
                                              dropout=drop),
                                  AttnBlock(ch, dtype=dtype),
                                  ResnetBlock(ch, ch, dtype=dtype,
                                              dropout=drop)])
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        # the reference's `final` Sequential: norm, SiLU (fused), conv, conv
        self.final = nn.ModuleList([GroupNormAct(ch, 32, "silu", dtype),
                                    nn.Identity(), conv3x3(ch, zc, dtype),
                                    conv1x1(zc, cfg.z_channels, dtype)])
        if dsl_nonpair:
            self.sigmas = _sigmas(dsl_init_sigma)

    def forward(self, x, blur: bool = False):
        taps = _Taps(self, blur)
        h = self.conv_in(x.to(self.dtype))
        taps.append(h)
        for blk in self.down:
            h = blk(h)
        taps.append(h)
        for blk in self.mid:
            h = blk(h)
        taps.append(h)
        f = self.final
        h = f[3](f[2](f[0](h)))
        taps.append(h)
        return h, taps.taps


class Decoder(nn.Module):
    """Decoder with optional FCM branches returning (x_recon f32, 4 taps,
    h_pre), h_pre being the input of the final RGB conv
    (reference: models/codec.py:400-1128)."""

    def __init__(self, cfg: CodecConfig, fcm_kind: str = FCM_RES,
                 dsl_nonpair: bool = False, dsl_init_sigma: float = 3.0,
                 dtype=torch.bfloat16, gaussian_kernel: int = 9):
        super().__init__()
        if fcm_kind != FCM_RES:
            raise NotImplementedError(
                "the benchmark's reference decoder carries fcm_kind 'res' "
                f"only, not {fcm_kind!r}")
        self.dtype = dtype
        self.gaussian_kernel = gaussian_kernel
        drop = cfg.dropout
        block_in = cfg.base_channels * cfg.ch_mult[-1]

        self.fcm_1 = self._fcm(cfg.z_channels, cfg)
        self.fcm_2 = self._fcm(block_in, cfg)
        self.fcm_3 = self._fcm(block_in, cfg)
        self.fcm_4 = self._fcm(cfg.base_channels * cfg.ch_mult[0], cfg)
        self.conv_in = conv3x3(cfg.z_channels, block_in, dtype)
        self.mid = nn.ModuleList([ResnetBlock(block_in, block_in, dtype=dtype,
                                              dropout=drop),
                                  AttnBlock(block_in, dtype=dtype),
                                  ResnetBlock(block_in, block_in, dtype=dtype,
                                              dropout=drop)])
        self.up = nn.ModuleList()
        ch = block_in
        res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
        for level in reversed(range(len(cfg.ch_mult))):
            out = cfg.base_channels * cfg.ch_mult[level]
            for _ in range(cfg.num_res_blocks + 1):
                self.up.append(ResnetBlock(ch, out, dtype=dtype, dropout=drop))
                ch = out
                if res in cfg.attn_resolutions:
                    self.up.append(AttnBlock(ch, dtype=dtype))
            if level != 0:
                self.up.append(Upsample(ch, dtype))
                res *= 2
        # the reference's `final` Sequential: norm, SiLU (fused), conv
        self.final = nn.ModuleList([GroupNormAct(ch, 32, "silu", dtype),
                                    nn.Identity(),
                                    conv3x3(ch, cfg.out_channels, dtype)])
        if dsl_nonpair:
            self.sigmas = _sigmas(dsl_init_sigma)

    def _fcm(self, c: int, cfg: CodecConfig) -> nn.Module:
        return ResnetBlock(c, c, dtype=self.dtype, dropout=cfg.dropout)

    def _apply_fcm(self, h, i: int, taps):
        """out = tap = fcm(h)."""
        t = getattr(self, f"fcm_{i}")(h)
        taps.append(t)
        return t

    def forward(self, z, blur: bool = False):
        taps = _Taps(self, blur)
        z = z.to(self.dtype)
        h = self._apply_fcm(z, 1, taps)
        h = self.conv_in(h)
        h = self._apply_fcm(h, 2, taps)
        for blk in self.mid:
            h = blk(h)
        h = self._apply_fcm(h, 3, taps)
        for blk in self.up:
            h = blk(h)
        h = self._apply_fcm(h, 4, taps)
        h_pre = self.final[0](h)
        x = self.final[2](h_pre)
        return x.float(), taps.taps, h_pre
