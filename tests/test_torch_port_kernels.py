"""favae_tpu_torch kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against the TPU kernels run in interpret mode and against the JAX plain
references, on the same seeded numpy inputs. The CUDA and Triton kernels
themselves run only on the card, where chip_smoke.py holds each against its
plain version.
"""

import ast
import pathlib

import jax
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


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_act_grads_match_pallas(act):
    """dx, dscale, dbias of the port's autograd.Function (plain backward on
    the CPU) against jax.grad through the TPU kernels in interpret mode
    (the oracle of tests/test_gn_pallas.py:53-70); f32, atol 1e-4 on
    gradients of order 1 (sums over 64 pixels in different orders)."""
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 8, 8, 128) * 2.0 + 0.5).astype(np.float32)
    scale = rng.randn(128).astype(np.float32)
    bias = rng.randn(128).astype(np.float32)
    w = rng.randn(2, 8, 8, 128).astype(np.float32)

    def loss(x, scale, bias):
        y = _gn_act_pallas(x, scale, bias, 32, 1e-5, act,
                           jnp.dtype(jnp.float32), True)
        return jnp.sum(y * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = gn.group_norm_act(xt, st, bt, 32, act=act)
    assert type(y.grad_fn).__name__ == "_GroupNormActBackward"
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    for ours, r, what in ((xt.grad.permute(0, 2, 3, 1), ref[0], "dx"),
                          (st.grad, ref[1], "dscale"),
                          (bt.grad, ref[2], "dbias")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_act_plain_backward_gradcheck(act):
    """The plain forward and backward in float64 against finite
    differences."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 3, 3, dtype=torch.float64, generator=g)
    scale = torch.randn(8, dtype=torch.float64, generator=g)
    bias = torch.randn(8, dtype=torch.float64, generator=g)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    scale.requires_grad_()
    bias.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: gn.group_norm_act_plain(x, s, b, 4, act=act),
        (x, scale, bias))


def test_group_norm_act_backward_honours_needs_input_grad():
    """Frozen affine parameters get no gradient; a frozen input gets no dx
    but its scale and bias still do; bf16 in, f32 out gives a bf16 dx."""
    x = torch.randn(1, 64, 4, 4)
    scale, bias = torch.ones(64, requires_grad=True), torch.zeros(64)
    xb = x.to(torch.bfloat16).requires_grad_()
    y = gn.group_norm_act(xb, scale, bias, 32, act="silu",
                          out_dtype=torch.float32)
    assert y.dtype == torch.float32
    y.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and scale.grad is not None
    assert bias.grad is None
    xf = x.clone()
    sf, bf = torch.ones(64, requires_grad=True), torch.zeros(64,
                                                           requires_grad=True)
    gn.group_norm_act(xf, sf, bf, 32).sum().backward()
    assert xf.grad is None and sf.grad.shape == (64,) and bf.grad.shape == (64,)


def test_group_norm_act_copies_non_channels_last_gradients():
    x = torch.randn(1, 64, 4, 4).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = gn.group_norm_act(x, torch.ones(64), torch.zeros(64), 32)
    before = gn.DY_COPIES["not_channels_last"]
    y.backward(torch.randn(1, 64, 4, 4))   # a contiguous NCHW gradient
    assert gn.DY_COPIES["not_channels_last"] == before + 1


def test_gn_backward_passes_match_autograd_of_plain_forward():
    """gn_bwd_sums and gn_bwd_dx (CPU: their plain versions) composed by the
    Function equal autograd through F.group_norm + SiLU in float64."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 5, 5, dtype=torch.float64, generator=g)
    scale = torch.randn(64, dtype=torch.float64, generator=g)
    bias = torch.randn(64, dtype=torch.float64, generator=g)
    dy = torch.randn(2, 64, 5, 5, dtype=torch.float64, generator=g)
    ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ref = torch.autograd.grad(
        torch.nn.functional.silu(torch.nn.functional.group_norm(
            ins[0], 16, ins[1], ins[2], 1e-5)), ins, dy)
    ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ours = torch.autograd.grad(gn.group_norm_act(*ins, 16, act="silu"),
                               ins, dy)
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, atol=1e-10, rtol=1e-10)


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
    v = torch.empty(2, 64, device="meta")
    s, m = torch.ones(64, device="meta"), torch.empty(2, 32, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gn.gn_bwd_sums(x, x, v, v, s, m, m, "silu")
    with pytest.raises(ValueError, match="unsupported device"):
        gn.gn_bwd_dx(x, x, v, v, v, v, None)
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
