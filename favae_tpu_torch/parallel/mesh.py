"""Process groups and collectives (port of favae_tpu/parallel/mesh.py).

The JAX package runs one global-view step over a `(dp, tp)` device mesh,
and XLA inserts every reduction over the batch. Here each process is one
rank of `torch.distributed`, started by `torch.distributed.run` (torchrun),
and the port makes those reductions itself: `Mesh` holds this rank's place
in a `(dp, tp)` grid of ranks (tp ranks adjacent, as the JAX mesh's last
axis), the process group of its dp row and of its tp column, and the
device it runs on. Each collective below takes a `Group` and does nothing
without one or with a group of one rank, so a run with no process group,
or a world of one, launches no collective and computes what it computed
before.

Gloo reduces and broadcasts CUDA tensors but does not gather them, so a
gather over gloo goes through host memory. `STATS` counts the calls, the
bytes and the host seconds of every collective made here or by
`parallel.sharding` (a host clock: over gloo a call returns when the
reduction is done, over NCCL when it is queued).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from favae_tpu_torch import resolve_device

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
STATS = {"calls": 0, "bytes": 0, "host_s": 0.0}


def collective(fn, t: torch.Tensor, *args, **kwargs):
    """`fn(t, ...)`, a torch.distributed collective on `t`, counted in
    `STATS`."""
    t0 = time.perf_counter()
    out = fn(t, *args, **kwargs)
    STATS["host_s"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return out


def launcher_env() -> Optional[Dict[str, str]]:
    """torchrun's variables, or None where none is set. Raises where some
    but not all are set, or where they do not parse."""
    env = {k: os.environ.get(k) for k in LAUNCHER_VARS}
    if not any(env.values()):
        return None
    missing = [k for k, v in env.items() if not v]
    if missing:
        raise RuntimeError(f"incomplete launcher environment: {missing} unset "
                           "(start the ranks with torch.distributed.run)")
    try:
        rank, world, local = (int(env[k]) for k in LAUNCHER_VARS[:3])
        int(env["MASTER_PORT"])
    except ValueError as e:
        raise RuntimeError(f"malformed launcher environment {env}") from e
    if not (0 <= rank < world and 0 <= local <= rank):
        raise RuntimeError(f"launcher environment out of range: RANK {rank}, "
                           f"WORLD_SIZE {world}, LOCAL_RANK {local}")
    return env


def init_distributed(backend: str) -> Optional[int]:
    """Join the process group that torchrun's environment describes, over
    `backend` ("nccl" or "gloo"), and return LOCAL_RANK; None, doing
    nothing, where no launcher variable is set (favae_tpu/parallel/mesh.py:
    64-75). Unlike the JAX function it raises on a broken environment or
    a backend that fails, and never goes on as a single process."""
    env = launcher_env()
    if env is None:
        return None
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]))
    return int(env["LOCAL_RANK"])


def start_rank(device: str, backend: Optional[str] = None, tp: int = 1):
    """(device, mesh) of this process, for a CLI: without torchrun's
    environment `device` as given and no mesh (`tp` must then be 1);
    under it the process group joined over `backend` (default nccl on
    CUDA, gloo on the CPU; the choice is never switched on a failure),
    each rank on `cuda:LOCAL_RANK` unless `device` names one card for
    every rank (two ranks on one card need gloo), and the `(dp, tp)`
    mesh."""
    dev = resolve_device(device)
    env = launcher_env()
    if env is None:
        return dev, make_mesh(tp)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {env['LOCAL_RANK']} has no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(dev)
    init_distributed(backend or ("nccl" if dev.type == "cuda" else "gloo"))
    return dev, make_mesh(tp, dev)


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis of the mesh as this rank sees it: the process group, this
    rank's index in it and its size."""

    group: object
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank in the `(dp, tp)` grid: `dp` the group of ranks that share
    its tp index (they hold different samples), `tp` the group of ranks
    that share its dp index (they hold one sample set and split the GPT's
    weights); `world` all ranks."""

    rank: int
    world: int
    dp: Group
    tp: Group
    device: torch.device


def make_mesh(tp: int = 1, device=None) -> Optional[Mesh]:
    """The mesh of the initialised process group with `tp`-wide tensor
    parallelism, or None without a process group (where `tp` must be 1).
    Raises when the world size is not divisible by `tp`
    (favae_tpu/train/cat_trainer.py:58-59). Every rank must call it: each
    creates every group in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp < 1 or world % tp:
        raise ValueError(f"world size {world} not divisible by tp={tp}")
    if not dist.is_initialized():
        return None
    rank = dist.get_rank()
    dp = world // tp
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)])
                 for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)])
                 for d in range(dp)]
    d, t = divmod(rank, tp)
    return Mesh(rank=rank, world=world,
                dp=Group(dp_groups[t], d, dp), tp=Group(tp_groups[d], t, tp),
                device=torch.device("cpu" if device is None else device))


def world_group() -> Optional[Group]:
    """All ranks, or None without a process group."""
    if not dist.is_initialized():
        return None
    return Group(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# collectives: each a no-op (the tensor as it is) with no group or a group
# of one rank

def spans(g: Optional[Group]) -> bool:
    """Whether `g` holds more than this rank."""
    return g is not None and g.size > 1


def _reduced(t: torch.Tensor, g: Group, **kwargs) -> torch.Tensor:
    """An all-reduce of a copy of `t` (NCCL takes only contiguous tensors),
    returned in `t`'s memory layout, so that what follows runs as it would
    on `t`."""
    flat = t.detach().clone(memory_format=torch.contiguous_format)
    collective(dist.all_reduce, flat, group=g.group, **kwargs)
    if t.is_contiguous():
        return flat
    out = torch.empty_like(t)
    out.copy_(flat)
    return out


def all_reduce_sum(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """The sum over `g` of `t`, a new tensor (no autograd)."""
    if not spans(g):
        return t
    return _reduced(t, g)


def all_reduce_mean(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    if not spans(g):
        return t
    return all_reduce_sum(t, g) / g.size


def all_reduce_max(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    if not spans(g):
        return t
    return _reduced(t, g, op=dist.ReduceOp.MAX)


def all_gather_rows(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated along dim 0 in rank
    order (no autograd)."""
    return all_gather_dim(t, 0, g)


def all_gather_dim(t: torch.Tensor, dim: int,
                   g: Optional[Group]) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated along `dim`, bit for
    bit."""
    if not spans(g):
        return t
    t = t.detach().contiguous()
    if dist.get_backend(g.group) == "nccl":
        parts = [torch.empty_like(t) for _ in range(g.size)]
        collective(lambda x: dist.all_gather(parts, x, group=g.group), t)
    else:
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(g.size)]
        collective(lambda x: dist.all_gather(parts, x, group=g.group), host)
        parts = [p.to(t.device) for p in parts]
    return torch.cat(parts, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the group of x, where each rank's later use of y
    gives only its part of dL/dy: the backward sums the gradient too."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _reduced(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _reduced(dy, ctx.g), None


def all_reduce_sum_grad(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """`all_reduce_sum` that carries a gradient (summed over the group in
    the backward) where `t` has one."""
    if not spans(g):
        return t
    if not (torch.is_grad_enabled() and t.requires_grad):
        return all_reduce_sum(t, g)
    return _AllReduceSum.apply(t, g)


def rows_of(t: torch.Tensor, g: Optional[Group], n: int) -> torch.Tensor:
    """This rank's `n` rows of a tensor `t` whose rows are the global
    batch's, in rank order."""
    if not spans(g):
        return t
    return t[g.rank * n:(g.rank + 1) * n]


def all_reduce_grads_(params: Sequence[torch.Tensor], g: Optional[Group],
                      bucket_bytes: int = 64 << 20) -> None:
    """Replace each parameter's `.grad` with its mean over `g`, in flat
    buckets of one dtype of up to `bucket_bytes` (one all-reduce each).
    Parameters without a gradient are left without one (every rank has
    the same set). At a group of one the gradients keep their bits."""
    if not spans(g):
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: Dict[torch.dtype, list] = {}
    for t in grads:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, size = [], 0
        for t in ts + [None]:
            if t is not None:
                bucket.append(t)
                size += t.numel() * t.element_size()
            if bucket and (t is None or size >= bucket_bytes):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                collective(dist.all_reduce, flat, group=g.group)
                if g.size > 1:
                    flat /= g.size
                torch._foreach_copy_(bucket, [
                    v.view_as(b) for v, b in zip(
                        flat.split([b.numel() for b in bucket]), bucket)])
                bucket, size = [], 0


def assert_replicated(tensors: Sequence[torch.Tensor], g: Optional[Group],
                      what: str) -> None:
    """Raise unless every rank of `g` holds the same `tensors` (compared by
    f64 sums and sums of squares, one all-reduce each way)."""
    if not (spans(g) and tensors):
        return
    with torch.no_grad():
        s = torch.stack([torch.stack([t.double().sum(),
                                      t.double().square().sum()])
                         for t in tensors]).reshape(-1)
        hi, lo = all_reduce_max(s, g), -all_reduce_max(-s, g)
    if not torch.equal(hi, lo):
        raise RuntimeError(f"{what} differ between ranks: the ranks did not "
                           "start from one seed")


def attach_dp(module: torch.nn.Module, g: Optional[Group]) -> None:
    """Give every submodule that reduces over the batch (those with a `dp`
    attribute: the quantizer, the BatchNorms, ActNorm's init) the dp
    group."""
    for m in module.modules():
        if hasattr(m, "dp"):
            m.dp = g
