"""favae_tpu_torch kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against the TPU kernels run in interpret mode and against the JAX plain
references, on the same seeded numpy inputs. The CUDA and Triton kernels
themselves run only on the card, where chip_smoke.py holds each against its
plain version.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu.ops.gn_pallas import _gn_act_pallas, _gn_act_reference
from favae_tpu.ops.vq_pallas import vq_nearest_pallas
from favae_tpu_torch.ops import gn, vq

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _vq_inputs(metric, n, k, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    e = rng.randn(k, d).astype(np.float32)
    if metric == "cosine":
        return _unit(x), _unit(e), None
    return 2.0 * x, e, -np.sum(e * e, axis=-1)


@pytest.mark.parametrize("metric,n,k,d", [
    ("cosine", 256, 1024, 64),
    ("euclidean", 256, 1024, 64),
    ("cosine", 300, 1500, 32),   # K and N not multiples of any tile
    ("euclidean", 100, 70, 16),
])
def test_vq_nearest_plain_matches_pallas(metric, n, k, d):
    x, e, bias = _vq_inputs(metric, n, k, d, seed=n + k)
    scores = x.astype(np.float64) @ e.T.astype(np.float64)
    if bias is not None:
        scores += bias
    top2 = np.sort(scores, axis=-1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 1e-5, "near-tie in the inputs"

    ref = np.asarray(vq_nearest_pallas(
        jnp.asarray(x), jnp.asarray(e),
        None if bias is None else jnp.asarray(bias), interpret=True))
    ours = vq.vq_nearest(torch.from_numpy(x), torch.from_numpy(e),
                         None if bias is None else torch.from_numpy(bias))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_vq_nearest_ties_go_to_lowest_index():
    x = torch.ones(4, 8)
    e = torch.ones(6, 8)
    e[3:] *= 2.0                       # codes 3..5 tie for the best score
    assert vq.vq_nearest(x, e).tolist() == [3, 3, 3, 3]
    bias = torch.tensor([0.0, 0.0, 0.0, -1.0, 0.0, 0.0])
    assert vq.vq_nearest(x, e, bias).tolist() == [4, 4, 4, 4]


def test_vq_nearest_euclidean_is_nearest_code():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    e = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    ref = torch.cdist(x, e).argmin(dim=-1)
    assert torch.equal(vq.vq_nearest_euclidean(x, e).long(), ref)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_act_plain_matches_pallas_and_reference(act):
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 8, 8, 128) * 2.0 + 0.5).astype(np.float32)  # HW = 64
    scale = rng.randn(128).astype(np.float32)
    bias = rng.randn(128).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5,
            act)
    y_pallas = np.asarray(_gn_act_pallas(*args, jnp.dtype(jnp.float32), True))
    y_ref = np.asarray(_gn_act_reference(*args, jnp.float32))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW, channels_last view
    for fn in (gn.group_norm_act_plain, gn.group_norm_act):
        y = fn(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32,
               act=act)
        assert y.is_contiguous(memory_format=torch.channels_last)
        y = y.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(y, y_pallas, atol=1e-5, rtol=0)
        np.testing.assert_allclose(y, y_ref, atol=1e-5, rtol=0)


def test_group_norm_act_casts_after_silu():
    """SiLU runs in f32 before the cast to out_dtype, like the TPU kernel."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(1, 64, 4, 4).astype(np.float32))
    scale, bias = torch.ones(64), torch.zeros(64)
    y32 = gn.group_norm_act_plain(x, scale, bias, 32, act="silu")
    y16 = gn.group_norm_act_plain(x, scale, bias, 32, act="silu",
                                  out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.to(torch.bfloat16))


def test_group_norm_act_rejects_bad_arguments():
    x = torch.zeros(1, 48, 2, 2)
    with pytest.raises(ValueError):
        gn.group_norm_act(x, torch.ones(48), torch.zeros(48), 32)
    with pytest.raises(ValueError):
        gn.group_norm_act(x, torch.ones(48), torch.zeros(48), 16, act="gelu")


def test_wrappers_never_fall_back_off_the_cpu():
    """Only CPU tensors take the plain versions; any other device must
    launch the kernel or raise."""
    x = torch.empty(2, 64, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gn.group_norm_act(x, torch.ones(64, device="meta"),
                          torch.zeros(64, device="meta"), 32)
    with pytest.raises(ValueError, match="unsupported device"):
        vq.vq_nearest(torch.empty(8, 4, device="meta"),
                      torch.empty(16, 4, device="meta"))


def test_entry_points_raise_without_cuda(monkeypatch):
    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.cli import eval_favae
    from favae_tpu_torch.config import celebahq_expe5
    from favae_tpu_torch.models.vqgan import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(celebahq_expe5())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_favae.main(["--synthetic_data", "--max_images", "1"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_favae_tpu():
    files = sorted((ROOT / "favae_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "favae_tpu")
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {mod}"
