"""The CAT training data path and CLI of the port, on the CPU.

- Captioned datasets and batches: `SyntheticDataset(with_captions=True)`
  gives the JAX package's images and captions; `PklImageDataset` over a
  [path, caption] manifest gives (image, caption) like the JAX one; the
  loader stacks the arrays, keeps the captions a list, and with
  `drop_last=False` keeps the last partial batch.
- `data/manifest.py` and `cli/preprocess.py` write the JAX package's
  manifests on a temporary tree.
- `cli.train_cat` runs one short epoch at the tiny configuration on the
  CPU, on the full pipeline and with `--cache_latents` (the same updates:
  a loader over the cache replays the image loader's batches, the same
  generator draws the same masks), and with `--grad_accum 2`; it raises
  without a card unless given `--device cpu`, and `--tp 2` raises in a
  single process (tensor parallelism needs a torchrun launch whose world
  tp divides; tests/test_torch_port_ddp_cat.py runs it).
"""

import os
import pickle

import numpy as np
import pytest

from favae_tpu.data import manifest as jmanifest
from favae_tpu.data import pipeline as jpipe
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import preprocess, train_cat
from favae_tpu_torch.data import manifest
from favae_tpu_torch.data import pipeline as tpipe
from tests.cat_train_common import tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

PIL = pytest.importorskip("PIL.Image")


def test_synthetic_captions_match_jax():
    ours = tpipe.SyntheticDataset(16, size=5, seed=3, with_captions=True)
    ref = jpipe.SyntheticDataset(16, size=5, seed=3, with_captions=True)
    for i in (0, 4, 7):
        (x, cap), (rx, rcap) = ours.get(i), ref.get(i)
        np.testing.assert_array_equal(x, rx)
        assert cap == rcap == f"synthetic caption {i % 5}"
    assert isinstance(tpipe.SyntheticDataset(16, size=5).get(0), np.ndarray)


def _tree(tmp_path, n=3):
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.png"
        PIL.fromarray(np.full((20, 24, 3), 40 * i, np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_pkl_captions_and_loader_match_jax(tmp_path):
    paths = _tree(tmp_path)
    entries = [[p, f"a face number {i}"] for i, p in enumerate(paths)]
    pkl = tmp_path / "caps.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(entries, f)
    ours = tpipe.PklImageDataset(str(pkl), 16, with_captions=True)
    ref = jpipe.PklImageDataset(str(pkl), 16, with_captions=True)
    for i in range(3):
        (x, cap), (rx, rcap) = ours.get(i), ref.get(i)
        np.testing.assert_allclose(x, rx, atol=1e-6)
        assert cap == rcap
    loader = tpipe.DataLoader(ours, 2, num_workers=1, drop_last=False)
    batches = list(loader)
    assert len(loader) == len(batches) == 2
    assert batches[0][0].shape == (2, 16, 16, 3)
    assert batches[1][1] == ["a face number 2"]
    jl = jpipe.DataLoader(ref, 2, shuffle=False, drop_last=False,
                          num_workers=1)
    for (x, caps), (rx, rcaps) in zip(batches, jl):
        np.testing.assert_allclose(x, rx, atol=1e-6)
        assert caps == rcaps
    assert len(tpipe.DataLoader(ours, 2, num_workers=1)) == 1


def test_manifests_match_jax(tmp_path):
    hq = tmp_path / "hq"
    caps = tmp_path / "caps"
    hq.mkdir()
    caps.mkdir()
    mapping = tmp_path / "mapping.txt"
    mapping.write_text("idx orig_idx orig_file\n0 10 000010.jpg\n"
                       "1 11 000011.jpg\n2 12 000012.jpg\n")
    partition = tmp_path / "partition.txt"
    partition.write_text("000010.jpg 0\n000011.jpg 0\n000012.jpg 1\n")
    (caps / "000010.txt").write_text("smiling.\nglasses.\n")
    (caps / "000012.txt").write_text("a hat.\n")
    args = (str(hq), str(mapping), str(partition))
    for split in (0, 1):
        for root in (None, str(caps)):
            assert manifest.build_celebahq_manifest(
                *args, captions_root=root, split=split) == \
                jmanifest.build_celebahq_manifest(*args, captions_root=root,
                                                  split=split)
    imgs = tmp_path / "imagenet" / "train" / "n01"
    imgs.mkdir(parents=True)
    for name in ("b.JPEG", "a.png", "skip.txt"):
        (imgs / name).write_bytes(b"")
    got = manifest.build_imagenet_manifest(str(tmp_path / "imagenet"))
    assert got == jmanifest.build_imagenet_manifest(
        str(tmp_path / "imagenet")) and len(got) == 2
    out = tmp_path / "m" / "celeba.pkl"
    preprocess.main(["celebahq", "--hq_root", str(hq), "--mapping",
                     str(mapping), "--partition", str(partition),
                     "--captions_root", str(caps), "--out", str(out)])
    assert tpipe.load_manifest(str(out)) == \
        jmanifest.build_celebahq_manifest(*args, captions_root=str(caps))


ARGS = ["--ds", "t", "--synthetic_data", "--batch_size", "4", "--epochs",
        "1", "--synthetic_steps", "3", "--num_workers", "1", "--print_steps",
        "3", "--dropout", "0.1"]


def _run(tmp_path, *extra):
    return train_cat.main(ARGS + ["--device", "cpu", "--output_dir",
                                  str(tmp_path)] + list(extra),
                          cfg=tiny_cfg(tcfg, dropout=0.1))


def test_train_cat_cli_full_and_cached(tmp_path):
    full = _run(tmp_path)
    cached = _run(tmp_path, "--cache_latents")
    assert len(full["history"]) == 3 and full["precompute_s"] == 0
    assert cached["precompute_s"] > 0
    for a, b in zip(full["history"], cached["history"]):
        assert np.isfinite(a["loss_gpt"]) and a["loss_gpt"] == b["loss_gpt"]
    assert full["val"][0]["loss_gpt"] == cached["val"][0]["loss_gpt"]
    assert full["val"][0]["samples"] == 16
    accum = _run(tmp_path, "--grad_accum", "2")
    assert all(np.isfinite(h["loss_gpt"]) for h in accum["history"])
    assert os.path.isfile(tmp_path / "cat" / "t" / "train_cfg.json")


def test_train_cat_cli_needs_a_card_unless_told_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cat.main(ARGS + ["--output_dir", str(tmp_path)],
                       cfg=tiny_cfg(tcfg))


@pytest.mark.parametrize("flags", [["--tp", "2"]])
def test_train_cat_unported_flags_raise(tmp_path, flags):
    with pytest.raises(ValueError, match="world size 1 not divisible by tp=2"):
        _run(tmp_path, *flags)


def test_train_cat_flags_resolve_to_cat_celebahq():
    """The flags the card runs with give cat_celebahq's FA-VAE, CLIP and
    GPT widths; --gpt_unroll and --dropout_rng are accepted and ignored."""
    args = train_cat.build_parser().parse_args(
        ["--ds", "x", "--use_cosine_sim", "--gpt_unroll", "24",
         "--dropout_rng", "threefry"])
    cfg = train_cat.config_from_args(args)
    ref = tcfg.cat_celebahq()
    assert cfg.vqgan == ref.vqgan and cfg.clip == ref.clip
    for f in ("vocab_size", "n_layer", "n_embed", "n_head", "dim_head",
              "image_encoded_dim", "n_cond_embed", "max_text_len",
              "cond_drop_prob"):
        assert getattr(cfg.gpt, f) == getattr(ref.gpt, f), f
    assert cfg.gpt.remat == "none" and cfg.gpt.dropout == 0.1


@pytest.mark.parametrize("module", [
    "train.cat_step", "train.cat_trainer", "train.schedule",
    "data.latent_cache", "data.manifest", "cli.train_cat", "cli.preprocess"])
def test_slice_modules_import_no_jax_triton_or_kernel(module):
    """Slice 4's modules import neither JAX nor the JAX package (read from
    their source: this process has JAX loaded for the parity tests), and
    importing one loads no triton and builds no kernel."""
    import ast
    import importlib
    import sys

    mod = importlib.import_module(f"favae_tpu_torch.{module}")
    tree = ast.parse(open(mod.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "favae_tpu"), (module, name)
    assert "triton" not in sys.modules
    from favae_tpu_torch import _build
    assert not _build._LIBS, "importing a module must build no kernel"


@pytest.mark.parametrize("name,group", [
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "at::native::(anonymous namespace)::TensorListMetadata<3>>", "optimizer"),
    ("_apply_kernel", "group norm fwd (Triton)"),
    ("_stats_kernel", "group norm fwd (Triton)"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NTN", "conv / matmul"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float, false>", "layer norm"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel"
     "Template<float, float, 32u>", "layer norm")])
def test_profile_groups_tell_the_optimizer_from_group_norm(name, group):
    """The CAT step's profile: PyTorch's `_foreach` kernels are named
    `multi_tensor_apply_kernel`, which holds the GroupNorm apply kernel's
    name `_apply_kernel`; they go to the optimizer."""
    from favae_tpu_torch.profiling import kernel_group
    assert kernel_group(name) == group


def test_trainer_resume_warm_starts_from_a_reference_pt(tmp_path):
    """`--resume_path` with a reference-format CAT `.pt` loads the GPT
    (fresh AdamW); resuming a run, from `latest` (no path) or from a
    checkpoint directory, restores the GPT, its AdamW and the step."""
    import torch

    from favae_tpu_torch.train.cat_trainer import CATTrainer
    cfg = tiny_cfg(tcfg)
    src = CATTrainer(cfg, str(tmp_path), 2, 4, device="cpu", seed=5)
    sd = {k: v.clone() for k, v in src.cat.gpt.state_dict().items()}
    torch.save({"transformer_model": sd}, tmp_path / "cat.pt")
    tr = CATTrainer(cfg, str(tmp_path), 2, 4, device="cpu", seed=0)
    assert not torch.equal(tr.cat.gpt.tok_emb.weight, sd["tok_emb.weight"])
    tr.resume(str(tmp_path / "cat.pt"))
    for k, v in tr.cat.gpt.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert tr.state.opt.count == 0
    assert tr.state.opt.params[0] is next(tr.cat.gpt.parameters())
    tr.state.opt.count, tr.state.step = 5, 5
    tr.ckpt.on_epoch_end(0, 1.0, tr.state_dict())
    for path in (None, str(tmp_path / "best")):
        other = CATTrainer(cfg, str(tmp_path), 2, 4, device="cpu", seed=1)
        other.resume(path)
        assert other.start_epoch == 1 and other.state.step == 5
        assert other.state.opt.count == 5
        for k, v in other.cat.gpt.state_dict().items():
            assert torch.equal(v, sd[k]), k
