"""CLIP vision towers: ViT and ModifiedResNet (port of
favae_tpu/models/clip_vision.py; reference: CLIP/clip/model.py).

* `CLIPVisionTransformer` (model.py:208-243) with the reference repo's
  modified forward: every token embedding is projected and the output is
  `(ln_post(x) @ proj, cls)` (:236-243), so a consumer can cross-attend
  over the whole 1 + grid^2 sequence, as the modified `encode_text` does.
  Its blocks are the text tower's `ResidualAttentionBlock`.
* `CLIPModifiedResNet` (model.py:96-158): the 3-conv stem with an
  average pool, anti-aliased strided `Bottleneck`s (:10-55) and the
  `AttentionPool2d` head (:58-93), upstream as it is: the pooled
  embedding only.

Both are frozen encoders. Their BatchNorms run on the running statistics.
Parameters are named as OpenAI CLIP's `visual.` branch without the
prefix, so its state_dict loads directly (`convert.load_reference_clip_
vision`, `load_reference_clip_resnet`), and `convert.clip_vision_from_jax`
/ `clip_resnet_from_jax` carry the JAX package's trees. Inputs are NHWC
CLIP-normalised images, as the loader's `with_clip_image` gives them. No
trainer reads either tower, in this package or the JAX one.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import CLIPResNetConfig, CLIPVisionConfig
from favae_tpu_torch.models.clip_text import ResidualAttentionBlock


class CLIPVisionTransformer(nn.Module):
    """ViT with the modified forward; convolution and blocks compute in
    `dtype`, the norms and the projection in f32."""

    def __init__(self, cfg: CLIPVisionConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c, scale = cfg, cfg.width ** -0.5
        grid = c.input_resolution // c.patch_size
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(c.width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(grid * grid + 1, c.width))
        self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(c.width, c.heads, dtype)
            for _ in range(c.layers))
        self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        self.proj = nn.Parameter(scale * torch.randn(c.width, c.output_dim))

    def forward(self, x):
        """x (B, R, R, 3) -> (token embeds (B, 1 + g^2, output_dim) f32,
        cls (B, output_dim))."""
        dt = self.dtype
        h = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.conv1.weight.to(dt),
                     stride=self.cfg.patch_size)
        b, w = h.shape[:2]
        h = h.reshape(b, w, -1).transpose(1, 2)
        h = torch.cat([self.class_embedding.to(dt).expand(b, 1, w), h], 1)
        h = self.ln_pre((h + self.positional_embedding.to(dt)[None]).float())
        for block in self.transformer.resblocks:
            h = block(h)
        out = self.ln_post(h.float()) @ self.proj
        return out, out[:, 0]


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics only (eps 1e-5), with the
    parameter and buffer names of `nn.BatchNorm2d`."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (model.py:10-55): every conv at stride 1; a
    stride above 1 is an average pool after conv2 and before the
    downsample branch's conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, out, 1, bias=False)),
                ("1", FrozenBatchNorm2d(out))]))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """The attention-pooling head (model.py:58-93): the spatial mean token
    prepended, a positional embedding added, one multi-head attention step
    with the mean token as the only query."""

    def __init__(self, spatial: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.randn(spatial * spatial + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x):
        """x (B, C, H, W) -> (B, output_dim)."""
        b, c = x.shape[:2]
        t = x.reshape(b, c, -1).transpose(1, 2)
        t = torch.cat([t.mean(1, keepdim=True), t], 1)
        t = t + self.positional_embedding[None]
        nh, n = self.heads, t.shape[1]
        dh = c // nh
        q = self.q_proj(t[:, :1]).reshape(b, 1, nh, dh)
        k = self.k_proj(t).reshape(b, n, nh, dh)
        v = self.v_proj(t).reshape(b, n, nh, dh)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                            * dh ** -0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, c)
        return self.c_proj(out)


class CLIPModifiedResNet(nn.Module):
    """model.py:96-158, frozen, in f32."""

    def __init__(self, cfg: CLIPResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(w)
        inplanes = w
        for i, blocks in enumerate(cfg.layers, start=1):
            planes = w * 2 ** (i - 1)
            layer = [Bottleneck(inplanes, planes, 1 if i == 1 else 2)]
            inplanes = planes * Bottleneck.expansion
            layer += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.input_resolution // 32, w * 32,
                                        cfg.heads, cfg.output_dim)

    def forward(self, x):
        """x (B, R, R, 3) -> pooled embedding (B, output_dim) f32."""
        h = x.permute(0, 3, 1, 2).float()
        for n in (1, 2, 3):
            h = F.relu(getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(h)))
        h = F.avg_pool2d(h, 2)
        for i in range(1, len(self.cfg.layers) + 1):
            h = getattr(self, f"layer{i}")(h)
        return self.attnpool(h)
