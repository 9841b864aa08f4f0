"""Driver `cat_gen`: CAT text-to-image requests through
`CATModel.sample_images`, as `cli/generate.py` builds the model and calls
it, in a closed loop: one request is one seeded prompt for `images`
images (2 x images CFG rows of 256 tokens, then the FA-VAE decode), the
images and the token grid read back to the host; the next request starts
when it ends. `route` picks the exact bf16 `GPT.sample` ("exact") or the
int8 serving engine ("quantized"). Every `greedy_every`-th request samples
with top-k 1 (greedy), so that its tokens can be held to the reference's
best; the others with the traffic's top-k, top-p, temperature and scale.

The check (after the window, the port freed) takes every greedy request
and a seeded sample of the others, runs the reference's CLIP text tower
and its GPT's full teacher-forced forward with CFG (float32, TF32 off) over
each prompt and its served tokens, and reads: `token_gap`, the widest gap
by which a greedy request's served token's logit lies below the
reference's best at its position; `nucleus_excess`, the most probability
mass that the reference puts on tokens ranked above a sampled token beyond
top-p (a token outside the reference's top-k counts its whole mass
above); and `recon_err`, the largest relative RMS error of a served image
against the reference FA-VAE's decode of the served grid.

Traffic parameters: route, images, prompt_lengths, top_k, top_p,
temperature, cond_scale, greedy_every, keep_share, max_kept,
warmup_requests, trace_seconds, control_requests, limits.
"""

from __future__ import annotations

import gc
import json
import sys

import numpy as np
import torch

from benchmark import cat
from benchmark.harness import Check, Window

MAX_REQUESTS = 1 << 16


class State:
    pass


def _params(tr, i: int) -> dict:
    greedy = tr["greedy_every"] and i % tr["greedy_every"] == 0
    return dict(top_k=1 if greedy else tr["top_k"], top_p=tr["top_p"],
                temperature=tr["temperature"], cond_scale=tr["cond_scale"])


def setup(ctx):
    from favae_tpu_torch import config as PC
    from favae_tpu_torch.models.txt_cond import build_cat

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    st = State()
    dev = ctx.device
    st.cfg = cat.cat_config(PC, cfg)
    st.cat = build_cat(st.cfg, dev, seed=0)
    vq_sd, clip_sd, gpt_sd = cat.make_weights(cfg, ctx.seed, dev)
    st.cat.favae.load_state_dict(vq_sd)
    st.cat.clip.load_state_dict(clip_sd)
    st.cat.gpt.load_state_dict(gpt_sd)
    del vq_sd, clip_sd, gpt_sd
    st.ids = torch.from_numpy(cat.prompts(
        ctx.seed, MAX_REQUESTS, tuple(tr["prompt_lengths"]),
        st.cfg.clip.vocab_size, st.cfg.clip.context_length))
    st.generator = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    rng = np.random.default_rng(ctx.seed + 2)
    st.keep = rng.random(MAX_REQUESTS) < tr["keep_share"]
    st.kept, st.timings = [], []
    st.next = 0
    for n in range(tr["warmup_requests"]):
        request(st, ctx, n, record=False)
    return st


def request(st, ctx, n: int, record: bool = True) -> None:
    """Request `n` of the window (or of the warm-up) on the next prompt:
    greedy where n is a multiple of `greedy_every`."""
    tr = ctx.cell.traffic
    i = st.next
    st.next += 1
    p = _params(tr, n)
    with ctx.spans("request"):
        text_ids = st.ids[i:i + 1].expand(tr["images"], -1).to(ctx.device)
        timings = {}
        imgs, grid = st.cat.sample_images(
            text_ids, generator=st.generator,
            quantized=tr["route"] == "quantized", timings=timings, **p)
        imgs, grid = imgs.float().cpu(), grid.cpu()
    if not record:
        return
    st.timings.append(timings)
    sampled = [k for k in st.kept if k[1]["top_k"] != 1]
    if p["top_k"] == 1 or not sampled or (
            st.keep[i] and len(sampled) < tr["max_kept"]):
        st.kept.append((i, p, imgs, grid))


def window(st, ctx) -> Window:
    t0 = ctx.open_window()
    n = 0
    while not ctx.due and st.next < MAX_REQUESTS:
        request(st, ctx, n)
        n += 1
        ctx.tick()
    t1 = ctx.close_window()
    images = n * ctx.cell.traffic["images"]
    return Window(t0, t1, n, {"images_per_s": images / (t1 - t0)},
                  extra={"work_span": "request", "timings": st.timings,
                         "rows": 2 * ctx.cell.traffic["images"]})


@torch.no_grad()
def ref_logits(ref, ids: torch.Tensor, grid: torch.Tensor,
               cond_scale: float) -> torch.Tensor:
    """(B, S, vocab) CFG logits of the reference GPT's full forward over
    the prompt and the served tokens: position s predicts token s."""
    cfg, _, clip, gpt = ref
    embeds, _ = clip(ids)
    mask = ids > 0
    if cfg.normalize_clip:
        embeds = embeds / torch.linalg.norm(embeds, dim=-1, keepdim=True)
    tokens = grid.reshape(grid.shape[0], -1)
    return gpt.forward_with_cond_scale(tokens[:, :-1], embeds.float(), mask,
                                       cond_scale)


def judge(ref, ids, grid, imgs, p) -> dict:
    logits = ref_logits(ref, ids, grid, p["cond_scale"]).float()
    tokens = grid.reshape(grid.shape[0], -1).long()
    served = logits.gather(-1, tokens[..., None])[..., 0]
    out = {}
    if p["top_k"] == 1:
        out["token_gap"] = float((logits.max(-1).values - served).max())
    else:
        probs = torch.softmax(logits / p["temperature"], -1)
        above = logits > served[..., None]
        rank = above.sum(-1)
        mass = (probs * above).sum(-1)
        mass = torch.where(rank >= p["top_k"], torch.ones_like(mass), mass)
        out["nucleus_excess"] = float((mass - p["top_p"]).max())
    _, vq, _, _ = ref
    want = vq.decode_code(grid).float()
    err = ((imgs.float() - want) ** 2).mean((1, 2, 3)).sqrt() \
        / (want ** 2).mean((1, 2, 3)).sqrt()
    out["recon_err"] = float(err.max())
    return out


def check(st, ctx):
    tr = ctx.cell.traffic
    kept, ids_all = st.kept, st.ids
    del st.cat
    gc.collect()
    torch.cuda.empty_cache()
    ref = cat.reference(ctx.cell.config, ctx.seed, ctx.device)
    rows = []
    for i, p, imgs, grid in kept:
        ids = ids_all[i:i + 1].expand(tr["images"], -1).to(ctx.device)
        rows.append(judge(ref, ids, grid.to(ctx.device),
                          imgs.to(ctx.device), p))
    got = {k: max(r[k] for r in rows if k in r)
           for k in tr["limits"] if any(k in r for r in rows)}
    print("detail " + json.dumps({"requests_checked": len(rows),
                                  "greedy_checked": sum(
                                      "token_gap" in r for r in rows)}),
          file=sys.stderr)
    return [Check(k, got.get(k, float("nan")), v)
            for k, v in tr["limits"].items()]


def control(ctx) -> dict:
    """The control at the cell's own size: the reference with its GPT's
    projections and its FA-VAE's convolutions in fp8 put in the program's
    place, over the first `control_requests` prompts and a seeded grid of
    tokens for each, judged by the float32 reference as a run judges the
    program: `token_gap` of the token the fp8 model puts first at each
    position; `nucleus_excess` of the worst token inside the fp8 model's
    top-k / top-p set; `recon_err` of the fp8 decode of the grid."""
    from benchmark.reference.gpt import top_k_top_p_filter
    tr = ctx.cell.traffic
    ref = cat.reference(ctx.cell.config, ctx.seed, ctx.device)
    low = cat.reference(ctx.cell.config, ctx.seed, ctx.device, fp8=True)
    cfg = ref[0]
    ids_all = torch.from_numpy(cat.prompts(
        ctx.seed, tr["control_requests"], tuple(tr["prompt_lengths"]),
        cfg.clip.vocab_size, cfg.clip.context_length))
    g = cfg.gpt.image_encoded_dim
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 3)
    rows = []
    for i in range(tr["control_requests"]):
        ids = ids_all[i:i + 1].expand(tr["images"], -1).to(ctx.device)
        grid = torch.randint(0, cfg.gpt.vocab_size, (tr["images"], g, g),
                             generator=gen, device=ctx.device)
        want = ref_logits(ref, ids, grid, tr["cond_scale"]).float()
        got = ref_logits(low, ids, grid, tr["cond_scale"]).float()
        pick = got.argmax(-1, keepdim=True)
        allowed = top_k_top_p_filter(got, tr["top_k"], tr["top_p"]) > -1e8
        probs = torch.softmax(want / tr["temperature"], -1)
        order = want.argsort(-1, descending=True)
        above = torch.zeros_like(probs).scatter(
            -1, order, probs.gather(-1, order).cumsum(-1)
            - probs.gather(-1, order))
        rank = torch.zeros_like(probs).scatter(
            -1, order, torch.arange(probs.shape[-1], device=probs.device,
                                    dtype=probs.dtype).expand_as(probs))
        above = torch.where(rank >= tr["top_k"], 1.0, above)
        with torch.no_grad():
            want_img = ref[1].decode_code(grid).float()
            got_img = low[1].decode_code(grid).float()
        err = ((got_img - want_img) ** 2).mean((1, 2, 3)).sqrt() \
            / (want_img ** 2).mean((1, 2, 3)).sqrt()
        rows.append({
            "token_gap": float((want.max(-1).values
                                - want.gather(-1, pick)[..., 0]).max()),
            "nucleus_excess": float((above[allowed] - tr["top_p"]).max()),
            "recon_err": float(err.max())})
    return {"control": {k: max(r[k] for r in rows) for k in rows[0]}}


def counts(ctx) -> dict:
    """A token step's FLOPs and bytes at the configuration's shapes, at the
    mean position of the 256: the GPT's blocks (`roofline.token_step_counts`
    at bf16 weights, the exact route's) and the tied logits head."""
    from benchmark import roofline
    from benchmark.reference import config as RC
    cfg = cat.cat_config(RC, ctx.cell.config).gpt
    rows = 2 * ctx.cell.traffic["images"]
    seq = cfg.image_encoded_dim ** 2
    c = roofline.token_step_counts(cfg, rows, (seq - 1) / 2, 2)
    head = cfg.vocab_size * cfg.n_embed
    return {"token_flops": c["flops"] + 2 * rows * head,
            "token_bytes": c["bytes"] + 2 * head}
