"""The port's weights as reference-format `.pt` files (port of
favae_tpu/utils/torch_export.py).

The port's `state_dict()`s are already the reference's layout
(`convert.py`), so the FA-VAE's goes out as it is. The GPT's lacks the
entries that carry no weight of the model, which the reference's strict
`load_state_dict` still asks for (models/gpt_ca.py:250-282): the tied
`to_logits.weight`, the never-called `cond_proj`, a zero `beta` beside every
LayerNorm `gamma` and each self-attention's relative-position index buffer.
`reference_gpt_state_dict` adds them.
"""

from __future__ import annotations

from typing import Dict

import torch

from favae_tpu_torch.models.gpt import _rel_pos_indices


def _host_f32(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Contiguous CPU copies, floating tensors in f32 (integer buffers,
    such as `num_batches_tracked`, keep their dtype)."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            .cpu().contiguous() for k, v in sd.items()}


def save_favae_pt(path: str, model_sd: Dict[str, torch.Tensor],
                  epoch: int = 0, step: int = 0) -> None:
    """Write a VQGANFCM `state_dict` (discriminator and codebook state
    included) in the reference's format, {"model": sd, "epoch", "step"}
    (favae_scripts/train_favae.py:367-375)."""
    torch.save({"model": _host_f32(model_sd), "epoch": epoch, "step": step},
               path)


def reference_gpt_state_dict(gpt_sd: Dict[str, torch.Tensor], *,
                             image_encoded_dim: int = 16,
                             n_cond_embed: int = 768
                             ) -> Dict[str, torch.Tensor]:
    """A port GPT's `state_dict` completed for the reference's strict
    load (the inverse of `convert.load_reference_gpt`'s filter)."""
    sd = _host_f32(gpt_sd)
    out = dict(sd)
    tok = sd["tok_emb.weight"]
    out["to_logits.weight"] = tok  # tied head (gpt_ca.py:278-279)
    out["cond_proj.weight"] = torch.zeros(tok.shape[1], n_cond_embed)
    out["cond_proj.bias"] = torch.zeros(tok.shape[1])
    idx = torch.from_numpy(_rel_pos_indices(image_encoded_dim)).long()
    for k, v in sd.items():
        if k.endswith(".gamma"):
            out[k[:-len("gamma")] + "beta"] = torch.zeros_like(v)
        elif k.endswith(".rel_pos_bias.pos_bias.weight"):
            out[k[:-len("pos_bias.weight")] + "pos_indices"] = idx
    return out


def save_cat_pt(path: str, gpt_sd: Dict[str, torch.Tensor], *,
                image_encoded_dim: int = 16, n_cond_embed: int = 768,
                epoch: int = 0, best_score: float = float("inf"),
                step: int = 0) -> None:
    """Write a GPT `state_dict` as a reference-format CAT checkpoint,
    {"transformer_model": sd, "epoch", "best_score", "step"}
    (cat_scripts/train_cat.py:219-226)."""
    sd = reference_gpt_state_dict(gpt_sd, image_encoded_dim=image_encoded_dim,
                                  n_cond_embed=n_cond_embed)
    torch.save({"transformer_model": sd, "epoch": epoch,
                "best_score": best_score, "step": step}, path)
