"""What the FA-VAE cells share: the configuration file read into the port's
and the reference's config objects, the seeded weights, the reference's
train step and forward, and the comparison of leaf norms.

A configuration file (`configs/<name>.json`) holds the `model`, `loss` and
`train` groups as the port's dataclasses name their fields; the same file
gives the reference its copy of each, at float32.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence, Tuple

import torch

from benchmark.weights import default_rule, make_state

Norms = Dict[str, float]


def _vqgan(C, model: Dict):
    codec = dict(model["codec"])
    for k in ("ch_mult", "attn_resolutions"):
        codec[k] = tuple(codec[k])
    return C.VQGANConfig(
        codec=C.CodecConfig(**codec),
        quantizer=C.QuantizerConfig(**model["quantizer"]),
        discriminator=C.DiscriminatorConfig(**model["discriminator"]),
        fcm_kind=model["fcm_kind"], dsl_mode=model["dsl_mode"],
        compute_dtype=model["compute_dtype"])


def configs(C, config: Dict, seed: int, reference: bool = False):
    """(model, loss, train) configs of the module `C` (the port's
    `config` or the reference's copy); `seed` is the loader's and the
    step generator's (the weights come from `make_weights`). The reference
    computes in float32, spectra included."""
    model = _vqgan(C, config["model"])
    loss = C.LossConfig(**config["loss"])
    train = C.TrainConfig(**{**config["train"], "seed": seed})
    if reference:
        import dataclasses
        model = dataclasses.replace(model, compute_dtype="float32")
        loss = dataclasses.replace(loss, spectral_dtype="float32")
    return model, loss, train


def loader_seed(seed: int) -> int:
    """The loader's shuffle seed (numpy takes 32 bits; epochs add to it)."""
    return seed % (2 ** 31)


def weight_rule(config: Dict):
    model, loss = config["model"], config["loss"]
    cosine = model["quantizer"]["use_cosine_sim"]

    def rule(name: str, r: torch.Tensor) -> torch.Tensor:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "sigmas":
            return torch.full_like(r, float(loss["dsl_init_sigma"]))
        if leaf in ("embed", "embed_avg"):
            return (torch.nn.functional.normalize(r, dim=-1) if cosine
                    else r * r.shape[-1] ** -0.5)
        if name.startswith("lin") and leaf == "weight":
            return r.abs() / r.shape[1]  # LPIPS heads are non-negative
        return default_rule(name, r)
    return rule


def make_weights(config: Dict, seed: int, device
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(FA-VAE state_dict, LPIPS state_dict) made on `device` from `seed`,
    shaped by the reference's modules built on the meta device."""
    from benchmark.reference import config as RC
    from benchmark.reference.lpips import LPIPS
    from benchmark.reference.vqgan import VQGANFCM
    model_cfg, loss_cfg, _ = configs(RC, config, 0, reference=True)
    with torch.device("meta"):
        model = VQGANFCM(model_cfg, loss_cfg.gaussian_kernel,
                         loss_cfg.dsl_init_sigma)
        lpips = LPIPS(torch.float32)
    rule = weight_rule(config)
    model_sd = make_state(model.state_dict(), seed, device, rule)
    euclid = "quantizer._codebook.embed_avg"
    if euclid in model_sd:  # the EMA sums start at the codebook
        model_sd[euclid] = model_sd["quantizer._codebook.embed"].clone()
    lpips_sd = make_state(lpips.state_dict(), seed + 1, device, rule)
    return model_sd, lpips_sd


def reference_state(config: Dict, seed: int, device, fp8: bool = False):
    """The reference's train state (float32, TF32 off by the caller) with
    the seed's weights; `fp8` gives the control's precision."""
    from benchmark.reference import config as RC
    from benchmark.reference.favae_state import (FavaeTrainState,
                                                 make_optimizers)
    from benchmark.reference.lpips import LPIPS
    from benchmark.reference.precision import use_fp8
    from benchmark.reference.vqgan import VQGANFCM
    model_cfg, loss_cfg, train_cfg = configs(RC, config, loader_seed(seed),
                                             reference=True)
    if fp8:
        import dataclasses
        loss_cfg = dataclasses.replace(loss_cfg,
                                       spectral_dtype="float8_e4m3fn")
    model_sd, lpips_sd = make_weights(config, seed, device)
    with torch.device(device):
        model = VQGANFCM(model_cfg, loss_cfg.gaussian_kernel,
                         loss_cfg.dsl_init_sigma)
        lpips = LPIPS(torch.float32)
    model, lpips = model.to(device), lpips.to(device)
    model.load_state_dict(model_sd)
    lpips.load_state_dict(lpips_sd)
    model.eval()
    if fp8:
        use_fp8(model)
        use_fp8(lpips)
    lr = train_cfg.base_lr * train_cfg.batch_size
    opt_g, opt_d = make_optimizers(model, train_cfg, lr)
    state = FavaeTrainState(model=model, lpips=lpips, opt_g=opt_g,
                            opt_d=opt_d)
    return state, (model_cfg, loss_cfg, train_cfg)


def leaf_names(model: torch.nn.Module) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def adam_grads(opts: Sequence, model: torch.nn.Module
               ) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as Adam got it, from its state after one
    step: exp_avg = (1 - b1) g."""
    names = leaf_names(model)
    return {names[id(p)]: _first_moment(opt, p).float() / (1.0 - b1)
            for opt in opts for group in opt.param_groups
            for b1 in [group["betas"][0]] for p in group["params"]}


def _first_moment(opt, p: torch.Tensor) -> torch.Tensor:
    """Adam's first moment of `p`; zeros where it never took a step."""
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m


def changes(model: torch.nn.Module, start: Dict[str, torch.Tensor],
            device="cpu") -> Dict[str, torch.Tensor]:
    """Each leaf's change from `start`, f32, on `device`: the parameters,
    and the floating buffers that `start` holds (the quantizer's EMA
    codebook and counts, the discriminator's running statistics)."""
    buffers = [(n, b) for n, b in model.named_buffers()
               if b.is_floating_point() and n in start]
    return {n: (p.detach().float() - start[n].float()).to(device)
            for n, p in [*model.named_parameters(), *buffers]}


def code_counts(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The quantizer's EMA code counts (each `cluster_size` buffer), f32 on
    the CPU."""
    return {n: b.detach().to("cpu", torch.float32, copy=True)
            for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] == "cluster_size"}


def code_numbers(port: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """(`code_mismatch`, `count_gap`) of two sets of EMA code counts taken
    after the same step: the share of the counted code assignments on which
    they disagree, sum |port - ref| / (2 sum ref), and the relative gap of
    their totals (each EMA update counts every row of its batch once)."""
    diff = sum(float((port[k].cpu() - ref[k].cpu()).abs().sum()) for k in ref)
    total = sum(float(ref[k].sum()) for k in ref)
    got = sum(float(port[k].sum()) for k in ref)
    return diff / (2.0 * total), abs(got - total) / total


def norms(tensors: Dict[str, torch.Tensor]) -> Norms:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def moved_elements(grads: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Where the reference's first gradient is above a thousandth of the
    median leaf's RMS gradient: the other entries (a key's bias under
    softmax, packed in one leaf with the query's and the value's) have a
    gradient nought to rounding and move under Adam by round-off alone."""
    rms = statistics.median(float(g.float().pow(2).mean().sqrt())
                            for g in grads.values())
    return {k: g.abs() >= 1e-3 * rms for k, g in grads.items()}


def masked_norms(tensors: Dict[str, torch.Tensor],
                 masks: Dict[str, torch.Tensor]) -> Norms:
    return {k: float(torch.linalg.vector_norm(
        tensors[k].to(m.device)[m])) for k, m in masks.items()}


def leaf_gap(port: Norms, ref: Norms, keep: Sequence[str],
             median: bool = False) -> Tuple[float, str]:
    """The worst (or the median) leaf's gap of norms, |port - ref|, over
    the larger of the reference's norm of that leaf and of the median
    leaf; with the leaf it was read at."""
    med = statistics.median(ref[k] for k in keep)
    gaps = sorted((abs(port[k] - ref[k]) / max(ref[k], med), k) for k in keep)
    return gaps[len(gaps) // 2] if median else gaps[-1]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)
