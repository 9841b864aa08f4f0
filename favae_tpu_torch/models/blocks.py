"""Codec building blocks (port of favae_tpu/models/blocks.py).

Activations are NCHW tensors in `torch.channels_last` memory format.
Parameters are f32; convolutions and linear layers compute in `dtype` with
the weights cast at call time, as flax `dtype=` does. Softmax and LayerNorm
run in f32. Every GroupNorm goes through `ops.gn.group_norm_act`.
`AttnBlock`'s attention is the span `codec.attn`, and `STATS` counts its
calls and the score entries they form (`profiling.counters()`' `codec.*`).

Parameter names follow the reference's torch state_dict
(favae_tpu/utils/torch_export.py:47-84): a ResnetBlock is the reference's
`block` Sequential with the norms at 0 and 3 and the convs at 2 and 6, an
attention block packs q/k/v into MultiheadAttention's `in_proj_weight`.
Dropout is `F.dropout` under `self.training`, at the reference's places
(the ResnetBlock Sequential's index 5, the transformer layer's three); the
published presets set it to 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.ops.gn import group_norm_act
from favae_tpu_torch.profiling import span

# `AttnBlock` calls and the entries of their score matrices, B * L^2 a call
# (one head over L = H * W tokens)
STATS = {"attn_calls": 0, "attn_scores": 0}


class GroupNormAct(nn.Module):
    """GroupNorm (eps 1e-5) with an optionally fused SiLU; output in `dtype`."""

    def __init__(self, channels: int, num_groups: int = 32,
                 act: Optional[str] = None, dtype=torch.bfloat16):
        super().__init__()
        self.num_groups = num_groups
        self.act = act
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        return group_norm_act(x, self.weight, self.bias, self.num_groups,
                              act=self.act, out_dtype=self.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (params stay f32)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype=torch.bfloat16,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), w, b, self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (params stay f32)."""

    def __init__(self, cin: int, cout: int, compute_dtype=torch.bfloat16):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv3x3(cin, cout, dtype) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, compute_dtype=dtype)


def conv1x1(cin, cout, dtype) -> Conv2d:
    return Conv2d(cin, cout, 1, compute_dtype=dtype)


def _tokens(x):
    """(N, C, H, W) channels_last -> (N, H*W, C); a view."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def _image(t, h, w):
    """(N, H*W, C) -> (N, C, H, W) channels_last; a view of contiguous t."""
    n, _, c = t.shape
    return t.reshape(n, h, w, c).permute(0, 3, 1, 2)


class Upsample(nn.Module):
    """Nearest x2 + 3x3 conv (reference: models/codec.py:11-18)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv = conv3x3(channels, channels, dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """(0, 1, 0, 1) pad + stride-2 valid 3x3 conv (reference:
    models/codec.py:21-31)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _ResBody(nn.Module):
    """GN-SiLU-conv x2 as the reference's `block` Sequential: indices 1 and
    4 (SiLU) are fused into the norms, 5 is the dropout."""

    def __init__(self, cin: int, cout: int, num_groups: int, dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.block = nn.ModuleList([
            GroupNormAct(cin, num_groups, "silu", dtype), nn.Identity(),
            conv3x3(cin, cout, dtype),
            GroupNormAct(cout, num_groups, "silu", dtype), nn.Identity(),
            nn.Dropout(dropout), conv3x3(cout, cout, dtype)])

    def body(self, x):
        b = self.block
        return b[6](b[5](b[3](b[2](b[0](x)))))


class ResnetBlock(_ResBody):
    """GN-SiLU-conv x2 with residual (reference: models/codec.py:34-57)."""

    def __init__(self, cin: int, cout: int, num_groups: int = 32,
                 dtype=torch.bfloat16, dropout: float = 0.0):
        super().__init__(cin, cout, num_groups, dtype, dropout)
        self.shortcut = conv1x1(cin, cout, dtype) if cin != cout else None

    def forward(self, x):
        h = self.body(x)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return (x + h).to(x.dtype)


class NonResnetBlock(_ResBody):
    """ResnetBlock body without the residual: the conv-FCM (reference:
    models/codec.py:62-84; every FCM call site keeps cin == cout)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 dtype=torch.bfloat16, dropout: float = 0.0):
        super().__init__(channels, channels, num_groups, dtype, dropout)

    def forward(self, x):
        return self.body(x)


class _PackedAttention(nn.Module):
    """Parameters of torch nn.MultiheadAttention: q/k/v packed in
    `in_proj_weight` (3C, C) and `in_proj_bias`, then `out_proj`."""

    def __init__(self, channels: int, dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Linear(channels, channels, dtype)
        nn.init.zeros_(self.out_proj.bias)
        self.dtype = dtype

    def forward(self, y, num_heads: int):
        """Self-attention over tokens y (N, L, C), softmax in f32."""
        n, length, c = y.shape
        dt = self.dtype
        qkv = F.linear(y.to(dt), self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        qkv = qkv.view(n, length, 3, num_heads, c // num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (N, heads, L, dh)
        att = (q @ k.transpose(-1, -2)).float() * (c // num_heads) ** -0.5
        att = torch.softmax(att, dim=-1).to(dt)
        out = (att @ v).transpose(1, 2).reshape(n, length, c)
        return self.out_proj(out)


class AttnBlock(nn.Module):
    """GroupNorm + single-head self-attention over H*W tokens, residual
    (reference: models/codec.py:87-102)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.norm = GroupNormAct(channels, num_groups, None, dtype)
        self.attn = _PackedAttention(channels, dtype)

    def forward(self, x):
        h, w = x.shape[2:]
        with span("codec.attn"):
            out = self.attn(_tokens(self.norm(x)), num_heads=1)
        STATS["attn_calls"] += 1
        STATS["attn_scores"] += x.shape[0] * (h * w) ** 2
        return x + _image(out, h, w).to(x.dtype)


class _TransformerLayer(nn.Module):
    """Parameters and forward of torch nn.TransformerEncoderLayer: post-norm,
    ReLU, LayerNorms in f32, dropout after attention, ReLU and linear2."""

    def __init__(self, channels: int, num_heads: int, ffn_dim: int, dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.p = dropout
        self.self_attn = _PackedAttention(channels, dtype)
        self.norm1 = nn.LayerNorm(channels, eps=1e-5)
        self.linear1 = Linear(channels, ffn_dim, dtype)
        self.linear2 = Linear(ffn_dim, channels, dtype)
        self.norm2 = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, y):
        sa = self._drop(self.self_attn(y, self.num_heads))
        y = self.norm1((y + sa).float())
        ff = self._drop(self.linear2(self._drop(torch.relu(self.linear1(y)))))
        return self.norm2((y + ff).float())

    def _drop(self, t):
        return F.dropout(t, self.p, self.training)


class TransEncoderBlock(nn.Module):
    """GroupNorm + post-LN transformer encoder layer over H*W tokens, not
    added back to the input: the attention-FCM (reference:
    models/codec.py:108-122; 8 heads, ffn 2048)."""

    def __init__(self, channels: int, num_heads: int = 8, ffn_dim: int = 2048,
                 dtype=torch.bfloat16, dropout: float = 0.0):
        super().__init__()
        self.norm = GroupNormAct(channels, 32, None, dtype)
        self.attn = _TransformerLayer(channels, num_heads, ffn_dim, dtype,
                                      dropout)

    def forward(self, x):
        h, w = x.shape[2:]
        y = self.attn(_tokens(self.norm(x)))
        return _image(y, h, w).to(x.dtype)
