"""Carry weights into the port.

The port's parameters are named as the reference's torch state_dict, the
layout `favae_tpu/utils/torch_export.py` writes, so two sources load:

* `from_jax_params`: the JAX package's flax tree and codebook state (as
  numpy arrays) -> a state_dict; conv kernels HWIO -> OIHW, dense kernels
  (in, out) -> (out, in), separate q/k/v Dense layers packed into
  MultiheadAttention's `in_proj_weight`, the codebook gaining its leading
  num_codebooks axis of 1.
* `load_reference_checkpoint`: a reference-format `.pt`. The discriminator's entries are dropped (the
  port has no discriminator yet); everything else must match exactly.
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


def from_jax_params(params, cb_state, cfg: VQGANConfig
                    ) -> Dict[str, torch.Tensor]:
    """favae_tpu VQGANFCM params (flax tree of numpy arrays) and its
    CodebookState -> the port's VQGANFCM state_dict. The discriminator's
    params are ignored."""
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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Strictly load a reference-format `.pt` ({"model": state_dict, ...})
    into a port VQGANFCM, minus the discriminator."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    sd = {k: v for k, v in sd.items() if not k.startswith("discriminator.")}
    model.load_state_dict(sd, strict=True)
