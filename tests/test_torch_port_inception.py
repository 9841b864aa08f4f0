"""The port's FID InceptionV3, its resize to 299, the Fréchet distance and
the eval CLI's rFID and saved reconstructions, on the CPU.

The JAX side is `favae_tpu.models.inception` with seeded weights, as
tests/test_inception.py holds it (f32, no resize, 75 px); the weights reach
the port through pytorch-fid's layout (the helper below is a copy of the
one in tests/test_inception.py) and `load_inception`, the counterpart of
`convert_inception`. Features must agree within atol 1e-4, FID within 1e-6
relative, and the resize with `jax.image.resize` within 2e-5 on [0, 1]
images: upscaling agrees to 3e-7, and PyTorch's antialiasing weights
differ from JAX's by up to 1.2e-5 at 320 -> 299 (3e-7 at 400 and 600).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu.models import inception as jinc
from favae_tpu_torch.cli import eval_favae
from favae_tpu_torch.models import inception as tinc
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _torch_layout_state_dict(params, stats):
    """Flax inception tree -> torchvision-layout state dict (copy of
    tests/test_inception.py's helper)."""
    sd = {}

    def walk(p, s, prefix):
        if "conv" in p and "kernel" in p["conv"]:
            sd[prefix + ".conv.weight"] = np.asarray(
                p["conv"]["kernel"]).transpose(3, 2, 0, 1)
            sd[prefix + ".bn.weight"] = np.asarray(p["bn"]["scale"])
            sd[prefix + ".bn.bias"] = np.asarray(p["bn"]["bias"])
            sd[prefix + ".bn.running_mean"] = np.asarray(s["bn"]["mean"])
            sd[prefix + ".bn.running_var"] = np.asarray(s["bn"]["var"])
            return
        for k in p:
            walk(p[k], s[k], f"{prefix}.{k}" if prefix else k)

    walk(params, stats, "")
    return sd


def _seeded_stats(stats, seed):
    """Non-trivial BatchNorm statistics, so the fold is exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            (0.5 + rng.rand(*a.shape)) if "var" in jax.tree_util.keystr(path)
            else 0.1 * rng.randn(*a.shape), jnp.float32), stats)


def test_features_match_jax():
    model = jinc.InceptionV3FID(dtype=jnp.float32, resize_input=False)
    x = (np.random.RandomState(0).rand(2, 75, 75, 3) * 2 - 1).astype(
        np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = _seeded_stats(variables["batch_stats"], 1)
    ref = np.asarray(jax.jit(model.apply)(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x)))

    sd = _torch_layout_state_dict(variables["params"], stats)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    sd["fc.weight"] = torch.zeros(1008, 2048)  # pytorch-fid's head, dropped
    sd["fc.bias"] = torch.zeros(1008)
    ours = tinc.InceptionV3FID(torch.float32, resize_input=False)
    tinc.load_inception(ours, sd)
    feats = ours(torch.from_numpy(x)).numpy()
    assert feats.shape == (2, tinc.FID_DIM) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", [256, 320, 400, 64])
def test_resize_matches_jax_image_resize(size):
    """Up (256, 64 -> 299: no antialias) and down (320, 400 -> 299: JAX's
    default antialias) against `jax.image.resize(..., "bilinear")`."""
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                      method="bilinear"))
    ours = tinc.resize_to_fid(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("shift", [0.0, 0.3, 2.0])
def test_fid_matches_jax(shift):
    rng = np.random.RandomState(3)
    a = rng.randn(120, 24)
    b = rng.randn(100, 24) * 1.3 + shift
    ref = jinc.fid_from_features(a, b)
    ours = tinc.fid_from_features(a, b)
    assert abs(ours - ref) <= 1e-6 * max(abs(ref), 1.0)
    mu, sig = np.ones(4), np.eye(4) * 2.0
    assert tinc.frechet_distance(mu, sig, mu * 3, sig) == pytest.approx(
        jinc.frechet_distance(mu, sig, mu * 3, sig), rel=1e-6)


def test_eval_cli_rfid_and_saved_recons(tmp_path):
    """expe5 at full width on 16 px images with a seeded pytorch-fid-layout
    Inception file: `rfid` is finite and the [input | recon] PNGs are
    written, one per image."""
    from PIL import Image
    gen = torch.Generator().manual_seed(0)
    sd = tinc.InceptionV3FID(torch.float32).state_dict()
    for k, v in sd.items():
        if k.endswith("conv.weight"):  # He-scaled: ReLU keeps the scale
            sd[k] = torch.randn(v.shape, generator=gen) * (
                2.0 / v[0].numel()) ** 0.5
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    torch.save(sd, tmp_path / "pt_inception.pt")
    out = tmp_path / "recons"
    m = eval_favae.main(["--preset", "celebahq_expe5", "--synthetic_data",
                         "--batch_size", "2", "--max_images", "4",
                         "--resolution", "16", "--num_workers", "1",
                         "--device", "cpu", "--inception_ckpt",
                         str(tmp_path / "pt_inception.pt"),
                         "--save_recons", str(out)])
    assert m["images"] == 4 and np.isfinite(m["rfid"]) and m["rfid"] > 0
    names = sorted(os.listdir(out))
    assert names == [f"recon_{i:04d}.png" for i in range(4)]
    assert Image.open(out / names[0]).size == (32, 16)
