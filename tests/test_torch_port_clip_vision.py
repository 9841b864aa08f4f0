"""The port's CLIP vision towers, the loader's CLIP view and the CAT
trainer's 3-tuple batches, on the CPU in f32.

- `CLIPVisionTransformer` (the modified forward: every token projected,
  and the cls row) and `CLIPModifiedResNet` (BatchNorm on perturbed
  running statistics) at tiny widths against the JAX modules, carried by
  `clip_vision_from_jax` / `clip_resnet_from_jax`; and from one OpenAI
  CLIP-layout state_dict (`visual.` prefix, BatchNorm counters included)
  read by the port's `load_reference_clip_*` and by the JAX package's
  `convert_clip_*`. Bound: 1e-5 of the largest output.
- `PklImageDataset(with_captions=True, with_clip_image=True)` gives the
  JAX loader's (image, CLIP image, caption) batches (bicubic 224, CLIP's
  mean and std), bit for bit.
- The port's CAT trainer takes those 3-tuples and drops the CLIP column,
  as the JAX trainer's `_prep_batch` does: an epoch over them equals an
  epoch over (image, caption) batches, bit for bit.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.data import pipeline as jpipe
from favae_tpu.models import clip_vision as jcv
from favae_tpu.utils.torch_convert import (convert_clip_resnet,
                                           convert_clip_vision)
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import (clip_resnet_from_jax,
                                     clip_vision_from_jax,
                                     load_reference_clip_resnet,
                                     load_reference_clip_vision)
from favae_tpu_torch.data import pipeline as tpipe
from favae_tpu_torch.models.clip_vision import (CLIPModifiedResNet,
                                                CLIPVisionTransformer)
from favae_tpu_torch.train.cat_trainer import CATTrainer
from tests.cat_train_common import port_cat
from tests.torch_threads import one_torch_thread  # noqa: F401

VIT = dict(input_resolution=32, patch_size=8, width=32, layers=2, heads=2,
           output_dim=16)
RESNET = dict(layers=(1, 2, 1, 1), width=8, heads=4, output_dim=16,
              input_resolution=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


def _images(res, seed):
    return np.random.RandomState(seed).randn(2, res, res, 3).astype(
        np.float32)


def test_vit_matches_jax():
    jm = jcv.CLIPVisionTransformer(jcfg.CLIPVisionConfig(**VIT))
    x = _images(32, 0)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"])
    ref_tokens, ref_cls = jm.apply({"params": params}, x)
    ours = CLIPVisionTransformer(tcfg.CLIPVisionConfig(**VIT))
    ours.load_state_dict(clip_vision_from_jax(params), strict=True)
    with torch.no_grad():
        tokens, cls = ours(torch.from_numpy(x))
    assert tokens.shape == (2, 1 + 16, 16)
    _close(tokens, ref_tokens)
    _close(cls, ref_cls)

    # one OpenAI-layout state_dict into both packages
    sd = {f"visual.{k}": v.numpy() * 1.01 for k, v in
          ours.state_dict().items()}
    sd["logit_scale"] = np.float32(4.6)
    load_reference_clip_vision(ours, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in sd.items()})
    ref_tokens, _ = jm.apply({"params": convert_clip_vision(sd)}, x)
    with torch.no_grad():
        tokens, _ = ours(torch.from_numpy(x))
    _close(tokens, ref_tokens)


def test_modified_resnet_matches_jax():
    jm = jcv.CLIPModifiedResNet(jcfg.CLIPResNetConfig(**RESNET))
    x = _images(64, 1)
    variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), x))
    rng = np.random.RandomState(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.rand(*v.shape) + 0.5 if "var" in
                         jax.tree_util.keystr(path)
                         else rng.randn(*v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    params = variables["params"]
    ref = jm.apply({"params": params, "batch_stats": stats}, x)
    ours = CLIPModifiedResNet(tcfg.CLIPResNetConfig(**RESNET))
    ours.load_state_dict(clip_resnet_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert out.shape == (2, 16)
    _close(out, ref)

    sd = {f"visual.{k}": v.numpy() for k, v in ours.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = np.int64(7)
    load_reference_clip_resnet(ours, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in sd.items()})
    jparams, jstats = convert_clip_resnet(sd, layers=RESNET["layers"])
    ref = jm.apply({"params": jparams, "batch_stats": jstats}, x)
    with torch.no_grad():
        _close(ours(torch.from_numpy(x)), ref)


@pytest.fixture
def captioned_manifest(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(4)
    entries = []
    for i in range(6):
        p = os.path.join(tmp_path, f"{i}.png")
        Image.fromarray(rng.randint(0, 256, (40 + i, 50, 3), np.uint8)).save(p)
        entries.append([p, f"caption {i}"])
    path = os.path.join(tmp_path, "m.pkl")
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return path


def test_with_clip_image_batches_match_jax(captioned_manifest):
    kw = dict(with_captions=True, with_clip_image=True)
    ours = tpipe.DataLoader(tpipe.PklImageDataset(captioned_manifest, 64, **kw),
                            3, num_workers=2)
    ref = jpipe.DataLoader(jpipe.PklImageDataset(captioned_manifest, 64, **kw),
                           3, shuffle=False, num_workers=2)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 2
    for (x, clip_x, caps), (rx, rclip, rcaps) in zip(got, want):
        assert clip_x.shape == (3, 224, 224, 3)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(clip_x, rclip)
        assert caps == rcaps


def test_cat_trainer_takes_clip_image_batches(tmp_path, captioned_manifest):
    losses = []
    for with_clip in (True, False):
        cat, cfg = port_cat()
        tr = CATTrainer(cfg, str(tmp_path / str(with_clip)), steps_per_epoch=2,
                        batch_size=3, device="cpu", cat=cat)
        ds = tpipe.PklImageDataset(captioned_manifest, 64, with_captions=True,
                                   with_clip_image=with_clip)
        tr.train_epoch(tpipe.DataLoader(ds, 3, num_workers=1), 0,
                       img_steps=0)
        losses.append([h["loss_gpt"] for h in tr.history])
    assert len(losses[0]) == 2 and losses[0] == losses[1]
