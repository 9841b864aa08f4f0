"""Driver `recon`: FA-VAE reconstruction requests through
`VQGANFCM.reconstruct`, as `cli/eval_favae.py` builds the model and calls
it, in a closed loop: one request asks the port's `DataLoader` (over a
`PklImageDataset` manifest of the seed's JPEG files) for a batch, moves it
to the card, reconstructs it and reads the codes and the reconstruction
back to the host; the next request starts when it ends.

A sample of the window's requests, drawn from the seed (`keep_share`), is
kept. The check reads their files with the reference's own loader, runs
the reference's encoder (float32, TF32 off) and scores every code, and
decodes the port's codes with the reference's decoder: `code_gap` is the
widest gap by which a code the port chose scores below the reference's best
code for that token, `recon_err` the largest relative RMS error of a port
reconstruction against the reference's decode of the same codes.

Traffic parameters: images, image_size, resolution, batch, loader_threads,
warmup_requests, keep_share, trace_seconds, limits.
"""

from __future__ import annotations

import gc
import json
import sys

import numpy as np
import torch

from benchmark import data, favae
from benchmark.feed import Feed
from benchmark.harness import Check, Window

MAX_REQUESTS = 1 << 20


class State:
    pass


def setup(ctx):
    from favae_tpu_torch import config as PC
    from favae_tpu_torch.data.pipeline import DataLoader, PklImageDataset
    from favae_tpu_torch.models.vqgan import build_model

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    st = State()
    dev = ctx.device
    model_cfg, loss_cfg, _ = favae.configs(PC, cfg, 0)
    st.manifest = data.write_image_set(ctx.workdir / "images", ctx.seed + 7,
                                       tr["images"], tr["image_size"], dev)
    model_sd, _ = favae.make_weights(cfg, ctx.seed, dev)
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
    st.keep = rng.random(MAX_REQUESTS) < tr["keep_share"]
    st.kept = []
    for _ in range(tr["warmup_requests"]):
        request(st, ctx, keep=False)
    return st


def request(st, ctx, keep: bool) -> None:
    with ctx.spans("loader"):
        x = st.feed.next()
    with ctx.spans("request"):
        xt = torch.from_numpy(x).to(ctx.device)
        x_recon, idx = st.model.reconstruct(xt)
        codes = idx.cpu().numpy()
        recon = x_recon.cpu().numpy()
    if keep:
        st.kept.append((st.feed.served[-1], codes, recon))


def window(st, ctx) -> Window:
    t0 = ctx.open_window()
    n = 0
    while not ctx.due and n < MAX_REQUESTS:
        request(st, ctx, keep=bool(st.keep[n]))
        n += 1
        ctx.tick()
    t1 = ctx.close_window()
    return Window(t0, t1, n, {"recon_images_per_s": n * st.batch / (t1 - t0)},
                  extra={"work_span": "request"})


def reference_model(ctx, seed: int, fp8: bool = False):
    """The reference FA-VAE (float32, TF32 off; `fp8` the control's
    precision) with the seed's weights, in eval mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, _ = favae.reference_state(ctx.cell.config, seed, ctx.device,
                                     fp8=fp8)
    return state.model.eval()


def batch_of(ctx, manifest, served, batch: int) -> np.ndarray:
    paths = data.read_manifest(manifest)
    epoch, k = served
    order = data.epoch_order(len(paths), 0, epoch, False)
    return data.decode([paths[j] for j in order[k * batch:(k + 1) * batch]],
                       ctx.cell.traffic["resolution"])


@torch.no_grad()
def token_scores(model, x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, K) f32 scores of every code for every token, whose argmax
    is the nearest code, from the reference's encoder."""
    from benchmark.reference.quantizer import l2norm
    from benchmark.reference.vq import code_scores
    q = model.quantizer
    z, _ = model.encoder(x.permute(0, 3, 1, 2))
    flat = z.permute(0, 2, 3, 1).float()
    shape = flat.shape[:3]
    flat = l2norm(flat.reshape(-1, flat.shape[-1]))
    embed = l2norm(q.state().embed)
    return code_scores(flat, embed).view(*shape, -1)


def judge(ref, x: torch.Tensor, codes: torch.Tensor, recon: torch.Tensor
          ) -> dict:
    """(code_gap, recon_err) of one request's answers against the
    reference."""
    scores = token_scores(ref, x)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    code_gap = float((scores.max(-1).values - chosen).max())
    want = ref.decode_code(codes.long()).float()
    err = ((recon.float() - want) ** 2).mean((1, 2, 3)).sqrt() \
        / (want ** 2).mean((1, 2, 3)).sqrt()
    return {"code_gap": code_gap, "recon_err": float(err.max())}


def worst(rows) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def checks(got: dict, limits: dict, detail: dict):
    print("detail " + json.dumps(detail), file=sys.stderr)
    return [Check(k, got[k], limits[k]) for k in limits]


def check(st, ctx):
    st.feed.close()
    kept, manifest, batch = st.kept, st.manifest, st.batch
    del st.model
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_model(ctx, ctx.seed)
    rows = []
    for served, codes, recon in kept:
        x = torch.from_numpy(batch_of(ctx, manifest, served, batch)).to(
            ctx.device)
        rows.append(judge(ref, x, torch.from_numpy(codes).to(ctx.device),
                          torch.from_numpy(recon).to(ctx.device)))
    if not rows:
        return [Check("requests_checked", 0.0, -1.0)]
    return checks(worst(rows), ctx.cell.traffic["limits"],
                  {"requests_checked": len(rows)})


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
        x = torch.from_numpy(batch_of(ctx, manifest, (0, k), tr["batch"])).to(
            ctx.device)
        with torch.no_grad():
            codes = token_scores(low, x).argmax(-1)
            recon = low.decode_code(codes)
        rows.append(judge(ref, x, codes, recon))
    return {"control": worst(rows)}


def counts(ctx) -> dict:
    """A request's matmul and convolution FLOPs and its GroupNorm calls'
    bytes (statistics and apply), from the reference's modules at the
    configuration's shapes and stated precision, on the meta device."""
    from benchmark import roofline
    from benchmark.reference import config as RC
    from benchmark.reference.vqgan import VQGANFCM
    model_cfg, loss_cfg, _ = favae.configs(RC, ctx.cell.config, 0)
    with torch.device("meta"):
        model = VQGANFCM(model_cfg, loss_cfg.gaussian_kernel,
                         loss_cfg.dsl_init_sigma).eval()
    r = ctx.cell.traffic["resolution"]
    x = torch.empty(ctx.cell.traffic["batch"], r, r, 3, device="meta")
    gn = roofline.GroupNormCalls()
    with gn.watch(model):
        flops = roofline.count_flops(lambda: model.reconstruct(x))
    return {"flops_per_request": flops,
            "gn_bytes_per_request": gn.bytes(backward=False)}
