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
