"""Frozen copy of the port's `config.py` dataclasses, the benchmark's
reference (imports nothing of the port; see ../README.md): the fields that
`configs/<name>.json` fills, for the reference's modules. The presets are
not copied; the configuration files are the benchmark's presets.

Mirrors the reference's argparse flag surface (reference:
favae_scripts/train_favae.py:392-438, cat_scripts/train_cat.py:252-312) as
frozen dataclasses. Options that the reference's modules do not carry raise
where a module is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Enumerations (plain strings so configs stay trivially serializable)
# ---------------------------------------------------------------------------

# Frequency Complement Module flavour in the decoder
# (reference dispatch: models/vqgan_fcm.py:58-96)
FCM_NONE = "none"    # plain taming decoder (models/codec.py:400)
FCM_CONV = "conv"    # NonResnetBlock FCM, output added back (models/codec.py:471,557,700)
FCM_RES = "res"      # ResnetBlock FCM applied inline (models/codec.py:794,882)
FCM_ATTN = "attn"    # TransEncoderBlock FCM 1-3 + ResnetBlock FCM 4 (models/codec.py:1011)

# Dynamic Spectrum Loss sigma topology
DSL_NONE = "none"        # no learned sigmas (plain FFL on taps, or no tap loss)
DSL_NONPAIR = "nonpair"  # encoder + decoder each own 4 sigmas (models/codec.py:215,898)
DSL_PAIR = "pair"        # 4 model-level shared sigmas (models/vqgan_fcm.py:67)


def _f(**kw):
    return dataclasses.field(**kw)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Encoder/decoder trunk config (reference: models/codec.py:125-188,400-465)."""

    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    resolution: int = 256
    z_channels: int = 256
    double_z: bool = False
    # groups for the decoder's first conv-FCM block (reference --num_groups,
    # models/codec.py:725); all other GroupNorms use 32 groups.
    num_groups: int = 32
    # train-mode dropout inside the attn-FCM blocks (reference: codec.py:113
    # wraps nn.TransformerEncoderLayer, whose default dropout is 0.1; the
    # variant's 4th FCM ResnetBlock uses the same rate). Exposed so parity
    # tests can pin the attn decoder deterministically.
    attn_fcm_dropout: float = 0.1

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Vector quantizer config (reference: models/l2_quantize.py:448-503)."""

    codebook_size: int = 1024
    dim: int = 256                      # latent channels entering the quantizer
    codebook_dim: Optional[int] = None  # projection dim (VitVQGAN style) or None
    use_cosine_sim: bool = True
    decay: float = 0.8
    eps: float = 1e-5
    commitment_weight: float = 1.0
    # dead-code expiry. The reference's VectorQuantize wrapper defaults this to 0
    # (disabled) and VQGANFCM never overrides it (models/l2_quantize.py:461).
    # When enabled, replacements are drawn per-code from the local batch with a
    # shared RNG key (static-shape substitute for the reference's variably-sized
    # all_gather at models/l2_quantize.py:82-115).
    threshold_ema_dead_code: float = 0.0
    sample_codebook_temp: float = 0.0
    kmeans_init: bool = False
    kmeans_iters: int = 10
    orthogonal_reg_weight: float = 0.0
    orthogonal_reg_active_codes_only: bool = False
    orthogonal_reg_max_codes: Optional[int] = None
    # The vendored EuclideanCodebook never EMA-updates `embed_avg`
    # (models/l2_quantize.py:299 uses the stale init value). False = fixed math.
    compat_stale_embed_avg: bool = False


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Discriminator config (reference: models/discriminator.py:141-218)."""

    kind: str = "conv"  # "conv" (Discriminator) | "patch" (PatchDiscriminator)
    in_channels: int = 3
    base_channels: int = 64
    num_layers: int = 3
    use_actnorm: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and gates (reference: favae_scripts/train_favae.py:392-438)."""

    perceptual_weight: float = 1.0
    disc_weight: float = 0.75
    codebook_weight: float = 1.0
    ffl_weight: float = 1.0        # image-level FFL
    dsl_weight: float = 0.01       # FFL on (blurred) feature taps ("DSL_weight_features")
    sl_weight: float = 0.0         # fixed-sigma Spectrum Loss
    gaussian_kernel: int = 9       # blur kernel size mu
    gaussian_sigma: float = 3.0    # fixed sigma for SL
    dsl_init_sigma: float = 3.0    # init for learned sigmas
    ffl_alpha: float = 1.0
    disc_start_epochs: int = 1
    ffl_start_epochs: int = 0
    # dtype of the DFT matmuls inside FFL/DSL/SL ("bfloat16" or "float32").
    # Explicit config — NOT sniffed from the backend — so the production bf16
    # spectra path is visible and test-pinnable. The distance/weight math
    # downstream is always float32. Presets use bfloat16 (the TPU-tuned
    # choice, see docs/ROADMAP.md); the default stays float32 = the
    # reference's FFT precision.
    spectral_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    """Full FA-VAE model config (reference: models/vqgan_fcm.py:44-110)."""

    codec: CodecConfig = _f(default_factory=CodecConfig)
    quantizer: QuantizerConfig = _f(default_factory=QuantizerConfig)
    discriminator: DiscriminatorConfig = _f(default_factory=DiscriminatorConfig)
    fcm_kind: str = FCM_RES
    dsl_mode: str = DSL_NONPAIR
    # dtype of conv/matmul compute inside the codec ("bfloat16" or "float32").
    # Params, GroupNorm statistics, FFT, and quantizer math stay float32.
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """FA-VAE trainer config (reference: favae_scripts/train_favae.py:234-382)."""

    batch_size: int = 8            # per-device batch
    base_lr: float = 2.0e-6        # lr = base_lr * batch_size * num_devices (:250-251)
    sigma_lr: float = 2.0e-7       # separate lr for pairwise-DSL sigmas (:296-299)
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    epochs: int = 800
    save_every_epoch: int = 1
    print_steps: int = 10
    img_steps: int = 100
    seed: int = 0
    # stage-1 recomputes reconstructions with the just-updated generator, exactly
    # like the reference (train_favae.py:105-113). False reuses the stage-0 recon
    # (one fewer E+G forward per step; slightly different D inputs).
    faithful_stage1_recompute: bool = True
    # Adam first-moment storage dtype (optax mu_dtype) for BOTH optimizers.
    # "float32" keeps reference-exact dynamics; "bfloat16" halves mu traffic
    # (a measured -17% step-time win on the CAT side, see
    # CATConfig.adam_mu_dtype — expected ~1% here since the FA-VAE step is
    # compute-bound at 63.9% MFU). Opt-in until chip-measured.
    adam_mu_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """CAT transformer config (reference: models/gpt_ca.py:250-282,396-429)."""

    vocab_size: int = 1024
    n_layer: int = 24
    n_embed: int = 1536
    n_head: int = 16
    dim_head: int = 64
    image_encoded_dim: int = 16     # token grid side; seq len = dim**2
    n_cond_embed: int = 768         # CLIP text token width (ViT-L/14)
    dropout: float = 0.1
    max_text_len: int = 128
    cond_drop_prob: float = 0.25
    # training-path rematerialization of the scanned blocks (identical math,
    # different memory/compute trade): "full" recomputes every block
    # activation in the backward (lowest HBM, +1 forward of FLOPs), "dots"
    # saves matmul outputs and recomputes only elementwise ops, "dots_nb"
    # saves Dense outputs but recomputes attention einsums, "none"
    # stashes everything (OOMs at gpt2_medium batch 8 on one v5e chip).
    # Measured at gpt2_medium batch 16 (one v5e): full 294.7 ms, dots 285.3,
    # dots_nb 274.5 (261.1 with train_unroll=24); "full" remains the
    # lowest-memory fallback.
    remat: str = "dots_nb"
    # unroll factor for the TRAINING-path layer scan (1 = rolled loop,
    # n_layer = fully unrolled; the incremental-decode path always unrolls).
    # Unrolling lets XLA optimize the per-layer gradient stacking statically
    # at the cost of compile time; identical math either way.
    train_unroll: int = 1
    # PRNG implementation for TRAINING dropout masks. "rbg" backs mask bits
    # with XLA's RngBitGenerator (the TPU hardware RNG): threefry mask
    # generation costs ~18 ms/step at gpt2_medium batch 16 — and is run
    # AGAIN in the remat backward. Same Bernoulli(1-p) masks statistically,
    # deterministic and remat-stable, but a different stream than JAX's
    # default; "threefry" restores the default stream bit-for-bit.
    dropout_rng_impl: str = "rbg"
    # TRAINING-path reparameterization: apply each pre-projection LayerNorm's
    # learned scale to the projection KERNEL ((gamma*x_hat) @ W == x_hat @
    # (gamma[:,None]*W); dropout commutes with a per-feature scale) so the
    # scale's gradient becomes a weight-sized reduction riding the existing
    # weight-grad matmuls instead of an activation-sized reduce (profiled
    # ~30 ms/step of small LN-scale grad reductions at gpt2_medium batch 16).
    # Identical function of the SAME param tree (checkpoints interchangeable);
    # numerics differ only in where bf16 rounding lands. Post-projection
    # out_norms keep the standard form. Decode path is unaffected.
    fold_ln_scale: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (reference: CLIP/clip/model.py:246-376). ViT-L/14 defaults."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 768  # projection dim


@dataclasses.dataclass(frozen=True)
class CATConfig:
    """CAT composition (reference: models/txt_cond_transformer.py:29-110)."""

    vqgan: VQGANConfig = _f(default_factory=VQGANConfig)
    gpt: GPTConfig = _f(default_factory=GPTConfig)
    clip: CLIPTextConfig = _f(default_factory=CLIPTextConfig)
    normalize_clip: bool = False
    # Compat: the reference keeps cond_drop_prob=0.25 ACTIVE during the
    # validation CE (models/gpt_ca.py:286,311-313 — the random drop mask is
    # not gated on .eval(), and txt_cond_transformer.py:112-125 never
    # overrides it). We deliberately default to a deterministic val metric
    # (no cond drop at eval); set True to reproduce the reference behavior.
    eval_cond_drop: bool = False
    top_k: int = 500
    top_p: float = 0.95
    cond_scale: float = 3.0
    base_lr: float = 2.0e-6
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    # Opt-in: store Adam's first moment in bf16 (optax mu_dtype). Halves the
    # mu read+write HBM traffic of the optimizer phase (~25 ms at ~80% of
    # roofline on the gpt2_medium step); off by default so the default
    # training dynamics stay bit-comparable to the reference's f32 AdamW.
    adam_mu_dtype: str = "float32"
    # Opt-in: store Adam's second moment in bf16 too (no optax equivalent —
    # see cat_step.scale_by_adam_nu). Cuts another ~8 B/param of optimizer
    # HBM traffic; riskier than bf16 mu (sqrt(nu) scales the step size, and
    # bf16's 8 mantissa bits put ~0.2% relative noise on it), so it is off
    # by default and gated on the same on-chip convergence validation as mu
    # (scripts/validate_mu_dtype.py --what nu).
    adam_nu_dtype: str = "float32"
    warmup_epochs: int = 20
    epochs: int = 200
    min_lr: float = 0.0
