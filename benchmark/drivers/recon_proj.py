"""Driver `recon_proj`: FA-VAE reconstruction requests, as the `recon`
driver makes them (its closed loop, spans, window and sample of kept
requests), for the configurations whose decoder adds its FCM(conv) taps
back and whose codebook is searched through a projection (`codebook_dim`
!= `dim`), such as `imagenet_f4`. The weights and the reference come from
`reference/vqgan_conv.py` (conv-FCM decoder, projected quantizer), which
the `recon` driver's reference does not carry.

The check reads `recon`'s two numbers, one of them in another form.
`code_gap`, the widest gap by which a code the port chose scores below
the reference's best code for that token, each token's scores taken on the
reference encoder's latent after the reference's `project_in`, is reported
(in the `detail` line) but not limited: with 3 latent channels the
configuration's bfloat16 itself moves ~3 % of a request's codes, a few of
them by as much as the fp8 control's widest (the reference computed in
bfloat16 reads as wide as the port; PERF.md §4). `code_gap_q999`, the
gap under which 99.9 % of a request's tokens lie, is limited: it reads the
bulk of the codes, where the two precisions stand apart. `recon_err` is
the largest relative RMS error of a port reconstruction against the
reference's decode of the same codes (`project_out`, then the conv-FCM
decoder).

Traffic parameters: as `recon`'s (images, image_size, resolution, batch,
loader_threads, warmup_requests, keep_share, control_requests,
trace_seconds, limits).
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from benchmark import data, favae
from benchmark.drivers import recon
from benchmark.feed import Feed
from benchmark.harness import Check
from benchmark.weights import make_state

# the quantile of a request's code gaps that is limited
CODE_QUANTILE = 0.999


def _reference_model(config: Dict, device, reference: bool):
    from benchmark.reference import config as RC
    from benchmark.reference.vqgan_conv import VQGANFCMConv
    model_cfg, loss_cfg, _ = favae.configs(RC, config, 0,
                                           reference=reference)
    with torch.device(device):
        model = VQGANFCMConv(model_cfg, loss_cfg.gaussian_kernel,
                             loss_cfg.dsl_init_sigma)
    # buffers made from numpy in the constructors are on the host
    return model.to(device)


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The FA-VAE state_dict made on `device` from `seed`, shaped by the
    reference's modules built on the meta device."""
    model = _reference_model(config, "meta", reference=True)
    return make_state(model.state_dict(), seed, device,
                      favae.weight_rule(config))


def setup(ctx):
    from favae_tpu_torch import config as PC
    from favae_tpu_torch.data.pipeline import DataLoader, PklImageDataset
    from favae_tpu_torch.models.vqgan import build_model

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    st = recon.State()
    dev = ctx.device
    model_cfg, loss_cfg, _ = favae.configs(PC, cfg, 0)
    st.manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                       tr["images"], tr["image_size"], dev)
    model_sd = make_weights(cfg, ctx.seed, dev)
    st.model = build_model(model_cfg, dev,
                           gaussian_kernel=loss_cfg.gaussian_kernel,
                           dsl_init_sigma=loss_cfg.dsl_init_sigma)
    st.model.load_state_dict(model_sd)
    del model_sd
    st.batch = tr["batch"]
    loader = DataLoader(PklImageDataset(str(st.manifest), tr["resolution"]),
                        st.batch, num_workers=tr["loader_threads"])
    st.feed = Feed(loader, ctx)
    rng = np.random.default_rng(ctx.seed)
    st.keep = rng.random(recon.MAX_REQUESTS) < tr["keep_share"]
    st.kept = []
    for _ in range(tr["warmup_requests"]):
        recon.request(st, ctx, keep=False)
    return st


window = recon.window


def reference_model(ctx, seed: int, fp8: bool = False):
    """The reference FA-VAE (float32, TF32 off; `fp8` the control's
    precision) with the seed's weights, in eval mode."""
    from benchmark.reference.precision import use_fp8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _reference_model(ctx.cell.config, ctx.device, reference=True)
    model.load_state_dict(make_weights(ctx.cell.config, seed, ctx.device))
    if fp8:
        use_fp8(model)
    return model.eval()


@torch.no_grad()
def token_scores(model, x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, K) f32 scores of every code for every token, whose argmax
    is the nearest code: the reference encoder's latent through
    `project_in`, against the codebook, both sides l2-normed."""
    from benchmark.reference.quantizer import l2norm
    from benchmark.reference.vq import code_scores
    q = model.quantizer
    z, _ = model.encoder(x.permute(0, 3, 1, 2))
    shape = (z.shape[0], z.shape[2], z.shape[3])
    flat = l2norm(q.project(z))
    embed = l2norm(q.state().embed)
    return code_scores(flat, embed).view(*shape, -1)


def judge(ref, x: torch.Tensor, codes: torch.Tensor, recon_x: torch.Tensor
          ) -> dict:
    """(code_gap, code_gap_q999, recon_err) of one request's answers
    against the reference."""
    scores = token_scores(ref, x)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    gaps = (scores.max(-1).values - chosen).flatten()
    want = ref.decode_code(codes.long()).float()
    err = ((recon_x.float() - want) ** 2).mean((1, 2, 3)).sqrt() \
        / (want ** 2).mean((1, 2, 3)).sqrt()
    return {"code_gap": float(gaps.max()),
            "code_gap_q999": float(torch.quantile(gaps, CODE_QUANTILE)),
            "recon_err": float(err.max())}


def check(st, ctx):
    st.feed.close()
    kept, manifest, batch = st.kept, st.manifest, st.batch
    del st.model
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_model(ctx, ctx.seed)
    rows = []
    for served, codes, recon_x in kept:
        x = torch.from_numpy(recon.batch_of(ctx, manifest, served, batch)) \
            .to(ctx.device)
        rows.append(judge(ref, x, torch.from_numpy(codes).to(ctx.device),
                          torch.from_numpy(recon_x).to(ctx.device)))
    if not rows:
        return [Check("requests_checked", 0.0, -1.0)]
    got = recon.worst(rows)
    return recon.checks(got, ctx.cell.traffic["limits"],
                        {"requests_checked": len(rows),
                         "code_gap": got["code_gap"]})


def control(ctx) -> dict:
    """The control at the cell's own size: the reference in fp8 put in the
    program's place over the first `control_requests` batches, its codes
    and decodes judged as the program's are."""
    tr = ctx.cell.traffic
    manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                    tr["images"], tr["image_size"],
                                    ctx.device)
    ref = reference_model(ctx, ctx.seed)
    low = reference_model(ctx, ctx.seed, fp8=True)
    rows = []
    for k in range(tr["control_requests"]):
        x = torch.from_numpy(recon.batch_of(ctx, manifest, (0, k),
                                            tr["batch"])).to(ctx.device)
        with torch.no_grad():
            codes = token_scores(low, x).argmax(-1)
            recon_x = low.decode_code(codes)
        rows.append(judge(ref, x, codes, recon_x))
    return {"control": recon.worst(rows)}


def counts(ctx) -> dict:
    """A request's matmul and convolution FLOPs and its GroupNorm calls'
    bytes (statistics and apply), from the reference's modules at the
    configuration's shapes and stated precision, on the meta device."""
    from benchmark import roofline
    model = _reference_model(ctx.cell.config, "meta", reference=False).eval()
    r = ctx.cell.traffic["resolution"]
    x = torch.empty(ctx.cell.traffic["batch"], r, r, 3, device="meta")
    gn = roofline.GroupNormCalls()
    with gn.watch(model):
        flops = roofline.count_flops(lambda: model.reconstruct(x))
    return {"flops_per_request": flops,
            "gn_bytes_per_request": gn.bytes(backward=False)}
