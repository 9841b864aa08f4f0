"""The FCM(conv) decoder of the port's `models/codec.py`, the benchmark's
reference for the configurations whose decoder adds its FCM taps back
(imports nothing of the port; see ../README.md). The encoder is
`codec.Encoder`, which does not depend on the FCM flavour.

Departures from `favae_tpu_torch/models/codec.py`: one flavour only,
`conv` (the port's `Decoder` also carries `none`, `res` and `attn`; a
config asking for another raises here); no `dsl_nonpair` sigmas (the
configurations that run this decoder keep their sigmas pairwise, in the
model); the taps are never blurred (reconstruction and decoding only).
The module and parameter names are the port's, so one state_dict loads
into both.

`NonResnetBlock` is the conv-FCM: the ResnetBlock body (GN-SiLU-conv x2)
without the residual. The first FCM, over the z channels, takes the
configuration's `num_groups` in both its norms; the other three take 32
(reference: models/codec.py:725, --num_groups). Each FCM's output is a tap
and is added back to its input: out = h + fcm(h).
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.blocks import (AttnBlock, GroupNormAct,
                                        ResnetBlock, Upsample, _ResBody,
                                        conv3x3)
from benchmark.reference.config import CodecConfig, FCM_CONV


class NonResnetBlock(_ResBody):
    """ResnetBlock body without the residual: the conv-FCM (reference:
    models/codec.py:62-84; every FCM call site keeps cin == cout)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 dtype=torch.bfloat16, dropout: float = 0.0):
        super().__init__(channels, channels, num_groups, dtype, dropout)

    def forward(self, x):
        return self.body(x)


class Decoder(nn.Module):
    """Decoder with conv-FCM branches returning (x_recon f32, 4 taps,
    h_pre), h_pre being the input of the final RGB conv
    (reference: models/codec.py:400-1128)."""

    def __init__(self, cfg: CodecConfig, fcm_kind: str = FCM_CONV,
                 dtype=torch.bfloat16):
        super().__init__()
        if fcm_kind != FCM_CONV:
            raise NotImplementedError(
                "the benchmark's conv-FCM reference decoder carries "
                f"fcm_kind 'conv' only, not {fcm_kind!r}")
        self.dtype = dtype
        drop = cfg.dropout
        block_in = cfg.base_channels * cfg.ch_mult[-1]

        self.fcm_1 = NonResnetBlock(cfg.z_channels, cfg.num_groups, dtype,
                                    drop)
        self.fcm_2 = NonResnetBlock(block_in, 32, dtype, drop)
        self.fcm_3 = NonResnetBlock(block_in, 32, dtype, drop)
        self.fcm_4 = NonResnetBlock(cfg.base_channels * cfg.ch_mult[0], 32,
                                    dtype, drop)
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

    def _apply_fcm(self, h, i: int, taps):
        """tap = fcm(h), out = h + tap."""
        t = getattr(self, f"fcm_{i}")(h)
        taps.append(t)
        return h + t

    def forward(self, z, blur: bool = False):
        if blur:
            raise NotImplementedError(
                "the conv-FCM reference decoder does not blur its taps")
        taps = []
        h = self._apply_fcm(z.to(self.dtype), 1, taps)
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
        return x.float(), taps, h_pre
