"""Carry weights into the port.

The port's parameters are named as the reference's torch state_dicts (the
layout `favae_tpu/utils/torch_export.py` writes, and `vgg16_lpips.pt`'s), so
these sources load:

* `from_jax_params`: the JAX package's flax tree, discriminator BatchNorm
  statistics and codebook state (as numpy arrays) -> a state_dict; conv
  kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), separate
  q/k/v Dense layers packed into MultiheadAttention's `in_proj_weight`, the
  codebook gaining its leading num_codebooks axis of 1.
* `lpips_from_jax`: the JAX LPIPS tree -> the port's LPIPS state_dict.
* `load_reference_checkpoint`: a reference-format `.pt`, discriminator
  included, loaded strictly.
* `clip_vision_from_jax` / `clip_resnet_from_jax` and
  `load_reference_clip_vision` / `load_reference_clip_resnet`: the CLIP
  vision towers from the JAX package's trees or OpenAI CLIP's state_dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from favae_tpu_torch.config import DSL_PAIR, FCM_NONE, VQGANConfig


def _conv(p) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _linear(p) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _norm(p) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _packed_qkv(p) -> Dict[str, np.ndarray]:
    return {
        "in_proj_weight": np.concatenate(
            [np.asarray(p[n]["kernel"]).T for n in ("q", "k", "v")], axis=0),
        "in_proj_bias": np.concatenate(
            [np.asarray(p[n]["bias"]) for n in ("q", "k", "v")], axis=0),
    }


def _put(sd: Dict[str, np.ndarray], prefix: str, sub: Mapping[str, Any]):
    for k, v in sub.items():
        sd[f"{prefix}.{k}" if prefix else k] = v


def block_state_dict(p) -> Dict[str, np.ndarray]:
    """One flax block's params -> the port block's state_dict: ResnetBlock /
    NonResnetBlock, AttnBlock, TransEncoderBlock, Upsample / Downsample."""
    sd: Dict[str, np.ndarray] = {}
    if "norm1" in p:  # the reference's `block` Sequential: 0, 2, 3, 6
        _put(sd, "block.0", _norm(p["norm1"]))
        _put(sd, "block.2", _conv(p["conv1"]))
        _put(sd, "block.3", _norm(p["norm2"]))
        _put(sd, "block.6", _conv(p["conv2"]))
        if "shortcut" in p:
            _put(sd, "shortcut", _conv(p["shortcut"]))
    elif "ln1" in p:  # nn.TransformerEncoderLayer behind a GroupNorm
        _put(sd, "norm", _norm(p["norm"]))
        _put(sd, "attn.self_attn", _packed_qkv(p))
        _put(sd, "attn.self_attn.out_proj", _linear(p["attn_out"]))
        _put(sd, "attn.norm1", _norm(p["ln1"]))
        _put(sd, "attn.linear1", _linear(p["ff1"]))
        _put(sd, "attn.linear2", _linear(p["ff2"]))
        _put(sd, "attn.norm2", _norm(p["ln2"]))
    elif "conv" in p:
        _put(sd, "conv", _conv(p["conv"]))
    else:  # AttnBlock: nn.MultiheadAttention behind a GroupNorm
        _put(sd, "norm", _norm(p["norm"]))
        _put(sd, "attn", _packed_qkv(p))
        _put(sd, "attn.out_proj", _linear(p["out"]))
    return sd


def _seq(sd, prefix: str, tree, name: str) -> None:
    i = 0
    while f"{name}_{i}" in tree:
        _put(sd, f"{prefix}.{i}", block_state_dict(tree[f"{name}_{i}"]))
        i += 1


def _batch_norm(sd, prefix: str, p, stats) -> None:
    """TorchBatchNorm: the flax scale/bias and mean/var, or the fresh
    running statistics (0, 1) when none are given."""
    _put(sd, prefix, _norm(p))
    c = np.asarray(p["scale"]).shape[0]
    sd[f"{prefix}.running_mean"] = (np.asarray(stats["mean"]) if stats
                                    else np.zeros((c,), np.float32))
    sd[f"{prefix}.running_var"] = (np.asarray(stats["var"]) if stats
                                   else np.ones((c,), np.float32))
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def discriminator_state_dict(p, stats, cfg: VQGANConfig
                             ) -> Dict[str, np.ndarray]:
    """The flax discriminator tree and its batch_stats (or None) -> the
    port's `discriminator.*` entries (favae_tpu/utils/torch_export.py:
    157-189)."""
    stats = stats or {}
    sd: Dict[str, np.ndarray] = {}
    dc = cfg.discriminator
    if dc.kind == "conv":
        _put(sd, "discriminator.features.0", _conv(p["conv_in"]))
        for i in range(1, dc.num_layers + 1):
            idx = 2 + 3 * (i - 1)
            _put(sd, f"discriminator.features.{idx}", _conv(p[f"conv_{i}"]))
            _batch_norm(sd, f"discriminator.features.{idx + 1}", p[f"bn_{i}"],
                        stats.get(f"bn_{i}"))
        _put(sd, "discriminator.head", _conv(p["head"]))
        return sd
    _put(sd, "discriminator.main.0", _conv(p["conv_in"]))
    idx = 2
    for n in range(1, dc.num_layers + 1):
        _put(sd, f"discriminator.main.{idx}", _conv(p[f"conv_{n}"]))
        norm, prefix = p[f"norm_{n}"], f"discriminator.main.{idx + 1}"
        if "loc" in norm:  # ActNorm: torch stores (1, C, 1, 1)
            sd[f"{prefix}.loc"] = np.asarray(norm["loc"]).reshape(1, -1, 1, 1)
            sd[f"{prefix}.scale"] = np.asarray(norm["scale"]).reshape(
                1, -1, 1, 1)
        else:
            _batch_norm(sd, prefix, norm, stats.get(f"norm_{n}"))
        idx += 3
    _put(sd, f"discriminator.main.{idx}", _conv(p["head"]))
    return sd


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(
        v, dtype=np.int64 if k.endswith("num_batches_tracked")
        else np.float32)) for k, v in sd.items()}


def from_jax_params(params, cb_state, cfg: VQGANConfig, batch_stats=None
                    ) -> Dict[str, torch.Tensor]:
    """favae_tpu VQGANFCM params (flax tree of numpy arrays), its
    CodebookState and optionally its batch_stats -> the port's VQGANFCM
    state_dict. Without batch_stats the discriminator's running statistics
    are the fresh ones (mean 0, variance 1)."""
    sd: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _put(sd, "encoder.conv_in", _conv(enc["conv_in"]))
    _seq(sd, "encoder.down", enc, "down")
    for i in range(3):
        _put(sd, f"encoder.mid.{i}", block_state_dict(enc[f"mid_{i}"]))
    _put(sd, "encoder.final.0", _norm(enc["final_norm"]))
    _put(sd, "encoder.final.2", _conv(enc["final_conv"]))
    _put(sd, "encoder.final.3", _conv(enc["final_proj"]))
    if "sigmas" in enc:
        sd["encoder.sigmas"] = np.asarray(enc["sigmas"])

    dec = params["decoder"]
    if cfg.fcm_kind == FCM_NONE:
        _put(sd, "decoder.quant_conv_in", _conv(dec["quant_conv_in"]))
    else:
        for i in (1, 2, 3, 4):
            _put(sd, f"decoder.fcm_{i}", block_state_dict(dec[f"fcm_{i}"]))
    _put(sd, "decoder.conv_in", _conv(dec["conv_in"]))
    for i in range(3):
        _put(sd, f"decoder.mid.{i}", block_state_dict(dec[f"mid_{i}"]))
    _seq(sd, "decoder.up", dec, "up")
    _put(sd, "decoder.final.0", _norm(dec["final_norm"]))
    _put(sd, "decoder.final.2", _conv(dec["final_conv"]))
    if "sigmas" in dec:
        sd["decoder.sigmas"] = np.asarray(dec["sigmas"])
    if cfg.dsl_mode == DSL_PAIR:
        sd["sigmas"] = np.asarray(params["sigmas"])

    q = params.get("quantizer", {})
    if "project_in" in q:
        _put(sd, "quantizer.project_in", _linear(q["project_in"]))
        _put(sd, "quantizer.project_out", _linear(q["project_out"]))
    sd["quantizer._codebook.embed"] = np.asarray(cb_state.embed)[None]
    sd["quantizer._codebook.cluster_size"] = \
        np.asarray(cb_state.cluster_size)[None]
    sd["quantizer._codebook.initted"] = np.ones((1,), np.float32)
    if not cfg.quantizer.use_cosine_sim:
        sd["quantizer._codebook.embed_avg"] = \
            np.asarray(cb_state.embed_avg)[None]
    sd.update(discriminator_state_dict(
        params["discriminator"], (batch_stats or {}).get("discriminator"),
        cfg))
    return _tensors(sd)


# torchvision vgg16.features conv indices of each LPIPS slice
_VGG_SLICE_CONV_IDX = [(1, (0, 2)), (2, (5, 7)), (3, (10, 12, 14)),
                       (4, (17, 19, 21)), (5, (24, 26, 28))]


def lpips_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX LPIPS tree ({"vgg": {"conv_i"}, "lin{k}"}) -> the port's LPIPS
    state_dict, laid out as the reference's `vgg16_lpips.pt`."""
    sd: Dict[str, np.ndarray] = {}
    ci = 0
    for s, idxs in _VGG_SLICE_CONV_IDX:
        for idx in idxs:
            _put(sd, f"net.slice{s}.{idx}", _conv(params["vgg"][f"conv_{ci}"]))
            ci += 1
    for k in range(5):
        sd[f"lin{k}.model.1.weight"] = np.asarray(
            params[f"lin{k}"]["kernel"]).transpose(3, 2, 0, 1)
    return _tensors(sd)


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Strictly load a reference-format `.pt` ({"model": state_dict, ...})
    into a port VQGANFCM, discriminator included."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    model.load_state_dict(sd, strict=True)


def read_lpips_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The reference's `vgg16_lpips.pt` as a state_dict for the port's
    LPIPS (load it strictly); the scaling layer's constant buffers, which
    the port keeps as non-persistent buffers, are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    return {k: v for k, v in sd.items()
            if not k.startswith("scaling_layer.")}


# ---------------------------------------------------------------------------
# CAT: GPT and CLIP text tower
# ---------------------------------------------------------------------------

def gpt_from_jax(params) -> Dict[str, torch.Tensor]:
    """The flax GPT tree as numpy arrays (the scan-stacked (L, ...) leaves
    under `blocks`) -> the port's `GPT.state_dict()`, which is the
    reference's layout without its dead entries
    (favae_tpu/utils/torch_export.py:218-273)."""
    sd: Dict[str, np.ndarray] = {
        "tok_emb.weight": np.asarray(params["tok_emb"]["embedding"]),
        "axial_height_pos": np.asarray(params["axial_height_pos"]),
        "axial_width_pos": np.asarray(params["axial_width_pos"]),
        "start_token": np.asarray(params["start_token"]),
        "init_norm.gamma": np.asarray(params["init_norm"]["ln"]["scale"]),
        "final_norm.gamma": np.asarray(params["final_norm"]["ln"]["scale"]),
    }
    blocks = params["blocks"]
    n_layer = np.asarray(blocks["self_attn"]["null_kv"]).shape[0]
    for i in range(n_layer):
        for j, name in ((0, "self_attn"), (1, "cross_attn")):
            p, pre = blocks[name], f"blocks.{i}.{j}"
            sd[f"{pre}.norm.gamma"] = np.asarray(p["norm"]["ln"]["scale"])[i]
            for lin in ("to_q", "to_kv", "to_out"):
                sd[f"{pre}.{lin}.1.weight"] = np.asarray(
                    p[lin]["kernel"])[i].T
            sd[f"{pre}.null_kv"] = np.asarray(p["null_kv"])[i]
            sd[f"{pre}.to_out.2.gamma"] = np.asarray(
                p["out_norm"]["ln"]["scale"])[i]
            if "rel_pos_bias" in p:
                sd[f"{pre}.rel_pos_bias.pos_bias.weight"] = np.asarray(
                    p["rel_pos_bias"]["pos_bias"]["embedding"])[i]
        ff, pre = blocks["ff"], f"blocks.{i}.2"
        sd[f"{pre}.0.gamma"] = np.asarray(ff["norm_in"]["ln"]["scale"])[i]
        sd[f"{pre}.1.weight"] = np.asarray(ff["fc1"]["kernel"])[i].T
        sd[f"{pre}.3.gamma"] = np.asarray(ff["norm_mid"]["ln"]["scale"])[i]
        sd[f"{pre}.4.weight"] = np.asarray(ff["fc2"]["kernel"])[i].T
    return _tensors(sd)


def clip_text_from_jax(params) -> Dict[str, torch.Tensor]:
    """The flax CLIPTextEncoder tree -> the port's state_dict, which is
    OpenAI CLIP's text-branch layout
    (favae_tpu/utils/torch_convert.py:281-309)."""
    sd: Dict[str, np.ndarray] = {
        "token_embedding.weight": np.asarray(
            params["token_embedding"]["embedding"]),
        "positional_embedding": np.asarray(params["positional_embedding"]),
        "text_projection": np.asarray(params["text_projection"]),
    }
    _put(sd, "ln_final", _norm(params["ln_final"]))
    _clip_blocks(sd, params)
    return _tensors(sd)


def _is_dead_gpt_entry(key: str) -> bool:
    """Entries of the reference GPT's state_dict that carry no weight of the
    model: the never-called `cond_proj`, the constant zero `beta` buffers,
    the tied `to_logits.weight` and the rel-pos index buffer."""
    return (key.startswith("cond_proj.") or key.endswith(".beta")
            or key == "to_logits.weight" or key.endswith(".pos_indices"))


def load_reference_gpt(gpt: torch.nn.Module, path_or_sd) -> None:
    """Load a reference-format CAT checkpoint (`CelebA_CAT.pt`:
    {"transformer_model": state_dict, ...}, or the state_dict itself) into a
    port GPT, strictly apart from the reference's dead entries."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "transformer_model" in sd:
        sd = sd["transformer_model"]
    gpt.load_state_dict({k: v for k, v in sd.items()
                         if not _is_dead_gpt_entry(k)}, strict=True)


def load_reference_clip_text(clip: torch.nn.Module, path_or_sd) -> None:
    """Load OpenAI CLIP's state_dict (whole, or already cut to the text
    branch) into a port CLIPTextEncoder: the vision tower and the scalar
    entries are dropped, the rest loads strictly."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    own = set(clip.state_dict())
    text = {k: v.float() for k, v in sd.items()
            if k in own or k.startswith(("transformer.", "ln_final."))}
    clip.load_state_dict(text, strict=True)


def _clip_blocks(sd: Dict[str, np.ndarray], params) -> None:
    i = 0
    while f"resblock_{i}" in params:
        p, pre = params[f"resblock_{i}"], f"transformer.resblocks.{i}"
        _put(sd, f"{pre}.ln_1", _norm(p["ln_1"]))
        _put(sd, f"{pre}.attn", _packed_qkv(p))
        _put(sd, f"{pre}.attn.out_proj", _linear(p["attn_out"]))
        _put(sd, f"{pre}.ln_2", _norm(p["ln_2"]))
        _put(sd, f"{pre}.mlp.c_fc", _linear(p["c_fc"]))
        _put(sd, f"{pre}.mlp.c_proj", _linear(p["c_proj"]))
        i += 1


def clip_vision_from_jax(params) -> Dict[str, torch.Tensor]:
    """The flax CLIPVisionTransformer tree -> the port's state_dict, OpenAI
    CLIP's `visual.` layout without the prefix
    (favae_tpu/utils/torch_convert.py:319-350, inverted)."""
    sd: Dict[str, np.ndarray] = {
        "conv1.weight": np.asarray(params["conv1"]["kernel"]).transpose(
            3, 2, 0, 1),
        "class_embedding": np.asarray(params["class_embedding"]),
        "positional_embedding": np.asarray(params["positional_embedding"]),
        "proj": np.asarray(params["proj"]),
    }
    _put(sd, "ln_pre", _norm(params["ln_pre"]))
    _put(sd, "ln_post", _norm(params["ln_post"]))
    _clip_blocks(sd, params)
    return _tensors(sd)


def clip_resnet_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """The flax CLIPModifiedResNet tree and its BatchNorm statistics -> the
    port's state_dict, OpenAI CLIP's `visual.` layout without the prefix
    (favae_tpu/utils/torch_convert.py:353-400, inverted)."""
    sd: Dict[str, np.ndarray] = {}

    def bn(dst, p, s):
        _put(sd, dst, {"weight": np.asarray(p["scale"]),
                       "bias": np.asarray(p["bias"]),
                       "running_mean": np.asarray(s["mean"]),
                       "running_var": np.asarray(s["var"])})

    for n in (1, 2, 3):
        _put(sd, f"conv{n}", _conv(params[f"conv{n}"]))
        bn(f"bn{n}", params[f"bn{n}"], batch_stats[f"bn{n}"])
    for name, bp in params.items():
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_")
        pre, bs = f"layer{li}.{bi}", batch_stats[name]
        for n in (1, 2, 3):
            _put(sd, f"{pre}.conv{n}", _conv(bp[f"conv{n}"]))
            bn(f"{pre}.bn{n}", bp[f"bn{n}"], bs[f"bn{n}"])
        if "downsample_conv" in bp:
            _put(sd, f"{pre}.downsample.0", _conv(bp["downsample_conv"]))
            bn(f"{pre}.downsample.1", bp["downsample_bn"],
               bs["downsample_bn"])
    ap = params["attnpool"]
    sd["attnpool.positional_embedding"] = np.asarray(
        ap["positional_embedding"])
    for n in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _put(sd, f"attnpool.{n}", _linear(ap[n]))
    return _tensors(sd)


def _reference_visual(path_or_sd) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP's state_dict (whole, or its `visual.` branch with or
    without the prefix) -> the vision branch without the prefix, f32,
    without BatchNorm's `num_batches_tracked` counters."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    return {k: v.float() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def load_reference_clip_vision(vit: torch.nn.Module, path_or_sd) -> None:
    """Load OpenAI CLIP's ViT vision branch into a port
    CLIPVisionTransformer, strictly (favae_tpu/utils/torch_convert.py:
    319-350)."""
    vit.load_state_dict(_reference_visual(path_or_sd), strict=True)


def load_reference_clip_resnet(resnet: torch.nn.Module, path_or_sd) -> None:
    """Load OpenAI CLIP's ModifiedResNet vision branch into a port
    CLIPModifiedResNet, strictly (favae_tpu/utils/torch_convert.py:
    353-400)."""
    resnet.load_state_dict(_reference_visual(path_or_sd), strict=True)
