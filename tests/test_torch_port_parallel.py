"""The port's `parallel/` package and the loader's shards on the CPU,
against the JAX package where it has a counterpart.

- `DataLoader(shard_index, shard_count)` gives the batches of
  `favae_tpu.data.pipeline.DataLoader` for shard counts 2 and 4, shuffled
  and in order, over two epochs, and the same lengths.
- `gpt_param_spec` splits each parameter of a 2-layer GPT as
  `gpt_param_pspec` does (column: to_q and fc1, row: to_out and fc2,
  everything else replicated), name for name through `gpt_from_jax`.
- `init_distributed` does nothing without torchrun's variables and raises
  on a partial or malformed set, or when the backend fails (it never
  switches backends); `make_mesh` raises where tp does not divide the
  world; `shard_gpt_` raises where tp does not divide the heads.
- In a one-rank gloo group the collectives keep every bit: the gradient
  buckets, the row gathers, the replica check.
- `cli.train_favae` as 2 gloo ranks: equal losses on both, the lr of the
  global batch, validation over the global images, one writer; and
  `--save_every_epoch 0` writes no checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from favae_tpu import config as jcfg
from favae_tpu.data import pipeline as jpipe
from favae_tpu.models import gpt as jgpt
from favae_tpu.parallel.sharding import gpt_param_pspec
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.data import pipeline as tpipe
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.parallel import mesh as pmesh
from favae_tpu_torch.parallel.sharding import (COLUMN, ROW, gpt_param_spec,
                                               shard_gpt_)
from tests.torch_dist_worker import free_port, launch
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=8)


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_shards_match_jax(count, shuffle):
    ds = tpipe.SyntheticDataset(4, size=37, seed=3)
    jds = jpipe.SyntheticDataset(4, size=37, seed=3)
    for i in range(count):
        ours = tpipe.DataLoader(ds, 3, num_workers=2, shuffle=shuffle, seed=5,
                                shard_index=i, shard_count=count)
        ref = jpipe.DataLoader(jds, 3, shuffle=shuffle, seed=5, num_workers=2,
                               shard_index=i, shard_count=count)
        assert len(ours) == len(ref) > 0
        for epoch in range(2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == len(ref)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _pspec_code(path, leaf):
    spec = tuple(gpt_param_pspec(path, leaf))
    if "tp" not in spec:
        return None
    # the kernel's last axis is its output (column split), the one before
    # its input (row split); (out, in) in the port's layout
    return COLUMN if spec.index("tp") == len(spec) - 1 else ROW


def test_gpt_param_spec_matches_jax():
    cfg = jcfg.GPTConfig(**SMALL)
    model = jgpt.GPT(cfg, dtype=jnp.float32)
    ctx = cfg.max_text_len
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 15), jnp.int32), jnp.zeros((1, ctx, 32)),
        jnp.ones((1, ctx), bool), cond_drop_prob=0.0),
        jax.random.PRNGKey(0))["params"]
    # each leaf filled with its own number, carried through the converter
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.full(leaf.shape, i, np.int64) for i, (_, leaf) in
         enumerate(leaves)])
    codes = [_pspec_code(path, leaf) for path, leaf in leaves]
    ref = {k: codes[int(v.flatten()[0])] for k, v in
           gpt_from_jax(tree).items()}
    gpt = GPT(tcfg.GPTConfig(**SMALL), dtype=torch.float32)
    ours = {n: gpt_param_spec(n, p) for n, p in gpt.named_parameters()}
    assert ours == ref
    split = sorted(n for n, d in ours.items() if d is not None)
    assert len(split) == 2 * (2 * 2 + 2)  # to_q, to_out twice, fc1, fc2


def _clear_launcher(monkeypatch):
    for k in pmesh.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)


def _launcher(monkeypatch, **over):
    env = {**dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port())),
           **over}
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_init_distributed_raises_and_never_falls_back(monkeypatch):
    _clear_launcher(monkeypatch)
    assert pmesh.init_distributed("gloo") is None
    assert pmesh.start_rank("cpu") == (torch.device("cpu"), None)
    assert pmesh.make_mesh(1) is None
    with pytest.raises(ValueError, match="world size 1 not divisible by tp=2"):
        pmesh.make_mesh(2)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete launcher environment"):
        pmesh.init_distributed("gloo")
    _launcher(monkeypatch, WORLD_SIZE="two")
    with pytest.raises(RuntimeError, match="malformed"):
        pmesh.init_distributed("gloo")
    _launcher(monkeypatch, RANK="2", WORLD_SIZE="2")
    with pytest.raises(RuntimeError, match="out of range"):
        pmesh.init_distributed("gloo")
    _launcher(monkeypatch)
    with pytest.raises(ValueError, match="unknown backend"):
        pmesh.init_distributed("mpi")
    if not dist.is_nccl_available():  # a failing backend is not replaced
        with pytest.raises(Exception):
            pmesh.init_distributed("nccl")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.start_rank("cuda")


def test_shard_gpt_needs_divisible_heads():
    gpt = GPT(tcfg.GPTConfig(**SMALL), dtype=torch.float32)
    with pytest.raises(ValueError, match="must divide the 4 heads"):
        shard_gpt_(gpt, pmesh.Group(None, 0, 3))


def test_one_rank_collectives_keep_bits(monkeypatch):
    _clear_launcher(monkeypatch)
    _launcher(monkeypatch)
    try:
        assert pmesh.init_distributed("gloo") == 0
        with pytest.raises(ValueError, match="world size 1 not divisible"):
            pmesh.make_mesh(3)
        mesh = pmesh.make_mesh(1)
        assert (mesh.dp.size, mesh.tp.size, mesh.dp.rank) == (1, 1, 0)
        g = torch.Generator().manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(s, generator=g))
                  for s in ((3, 5), (7,), (2, 2, 2))]
        grads = [torch.randn(p.shape, generator=g) for p in params]
        for p, gr in zip(params, grads):
            p.grad = gr.clone()
        params[1].grad = None
        pmesh.all_reduce_grads_(params, mesh.dp, bucket_bytes=64)
        assert params[1].grad is None
        for i in (0, 2):
            assert torch.equal(params[i].grad, grads[i])
        x = torch.randn(4, 3, generator=g)
        assert torch.equal(pmesh.all_gather_rows(x, mesh.dp), x)
        assert torch.equal(pmesh.all_reduce_mean(x, mesh.dp), x)
        pmesh.assert_replicated(params, pmesh.world_group(), "params")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_save_every_epoch_zero_writes_nothing(tmp_path):
    """The port-only `--save_every_epoch 0` of the smoke runs: no epoch,
    the last included, writes `latest` or `best`."""
    from favae_tpu_torch.utils.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every_epoch=0)
    for epoch in range(3):
        mgr.on_epoch_end(epoch, 1.0 - epoch, {"w": torch.ones(2)},
                         is_last=epoch == 2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == []


def test_train_favae_cli_on_two_ranks(tmp_path):
    """`cli.train_favae` as 2 gloo ranks (torchrun's variables): both ranks
    log the same losses, the lr counts both, validation counts the global
    images, and rank 0 alone writes the checkpoints."""
    argv = ["--ds", "dp", "--device", "cpu", "--output_dir", str(tmp_path),
            "--synthetic_data", "--synthetic_steps", "1", "--batch_size", "1",
            "--epochs", "2", "--disc_start_epochs", "1", "--resolution", "32",
            "--codebook_size", "64", "--embed_dim", "32", "--num_groups", "8",
            "--compute_dtype", "float32", "--num_workers", "1"]
    ranks = launch("favae_cli", dict(argv=argv), 2, tmp_path)
    keys = ("loss_g", "loss_d", "weight_d")
    losses = [[[h[k] for k in keys] for h in r["history"]] for r in ranks]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert all(np.isfinite(losses[0]).ravel())
    for r in ranks:
        assert r["lr"] == tcfg.TrainConfig().base_lr * 2
        assert [v["images"] for v in r["val"]] == [8, 8]
    assert sorted(p.name for p in (tmp_path / "dp").iterdir()) == [
        "best", "latest", "runs", "train_cfg.json"]
