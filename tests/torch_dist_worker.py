"""Ranks of the port's multi-process CPU tests, and the launcher that
starts them.

`launch(job, inputs, world, tmp_path)` starts `world` processes of
`python -m tests.torch_dist_worker` with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR 127.0.0.1 and a free
MASTER_PORT), joins them with a timeout, kills every one when one fails or
the time runs out (so a hang fails the test instead of the suite's time
limit), and returns each rank's result. Inputs and results travel as
`torch.save` files of numpy arrays, tensors and the port's config
dataclasses. This module imports no JAX: a rank starts in seconds, and
the parent test computes the JAX reference itself.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: str, inputs: Dict, world: int, tmp_path,
           timeout: float = 150.0) -> List[Dict]:
    """Run `job` on `world` gloo ranks; each rank's result dict."""
    tmp = pathlib.Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    src = tmp / f"{job}_in.pt"
    torch.save(inputs, src)
    port = free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        log = open(tmp / f"{job}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_worker", job, str(src),
             str(tmp / f"{job}_out{r}.pt")], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(
            f"--- rank {r} (rc {procs[r][0].returncode}):\n"
            + (tmp / f"{job}_rank{r}.log").read_text()[-3000:] for r in bad)
        raise AssertionError(f"{job}: ranks {bad} failed or hung "
                             f"(timeout {timeout} s)\n{tails}")
    return [torch.load(tmp / f"{job}_out{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# jobs: each runs on one rank and returns its result dict

def _np_sd(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _favae_state(inp, mesh):
    from favae_tpu_torch.parallel.mesh import attach_dp
    from favae_tpu_torch.train.favae_state import FavaeTrainState
    tm, tl, tt = inp["cfgs"]
    state = FavaeTrainState.create(
        tm, tl, tt, inp["lr"], "cpu",
        lpips_state_dict={k: torch.from_numpy(v)
                          for k, v in inp["lpips"].items()})
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in inp["model"].items()})
    attach_dp(state.model, mesh.dp)
    return state


def job_favae_step(inp, mesh) -> Dict:
    """Steps of the FA-VAE train step on this rank's rows of each global
    batch; the metrics, the model and the draws' use as the rank sees
    them."""
    from favae_tpu_torch.train.favae_step import make_train_step
    tm, tl, tt = inp["cfgs"]
    state = _favae_state(inp, mesh)
    metrics = []
    for i, (disc_on, ffl_on) in enumerate(inp["gates"]):
        x = torch.from_numpy(inp["x"][i]).chunk(mesh.dp.size)[mesh.dp.rank]
        step = make_train_step(tm, tl, tt, disc_on=disc_on, ffl_on=ffl_on,
                               dp=mesh.dp)
        draws = inp["draws"][i] if inp.get("draws") else None
        state, m = step(state, x, draws)
        metrics.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    return {"metrics": metrics, "model": _np_sd(state.model.state_dict())}


class ArrayDataset:
    def __init__(self, x):
        self.x = x

    def __len__(self):
        return len(self.x)

    def get(self, i):
        return self.x[i]


def job_favae_init(inp, mesh) -> Dict:
    """The trainer's first-batch inits (k-means from the given global
    permutation, ActNorm) on this rank's shard, then a validation over its
    shard of the val set."""
    from favae_tpu_torch.data.pipeline import DataLoader
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    tm, tl, tt = inp["cfgs"]
    tr = FavaeTrainer(tm, tl, tt, inp["save_dir"], device="cpu", mesh=mesh)
    tr.state.model.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in inp["model"].items()})
    x0 = inp["x0"].reshape(mesh.dp.size, -1, *inp["x0"].shape[1:])
    tr._data_dependent_init(x0[mesh.dp.rank], torch.from_numpy(inp["first"]))
    val = DataLoader(ArrayDataset(inp["val"]), inp["val_batch"],
                     shard_index=mesh.dp.rank, shard_count=mesh.dp.size)
    score = tr.validate(val, 0)
    return {"model": _np_sd(tr.state.model.state_dict()), "score": score,
            "val": tr.val[-1], "lr": tr.lr}


def _cat(inp):
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.models.txt_cond import build_cat
    cfg = inp["cfg"]
    cat = build_cat(cfg, "cpu", tokenizer=BPETokenizer(merges=inp["merges"]))
    cat.favae.load_state_dict({k: torch.from_numpy(v)
                               for k, v in inp["favae"].items()})
    cat.clip.load_state_dict({k: torch.from_numpy(v)
                              for k, v in inp["clip"].items()})
    cat.gpt = GPT(cfg.gpt, dtype=torch.float32)
    cat.gpt.load_state_dict({k: torch.from_numpy(v)
                             for k, v in inp["gpt"].items()})
    return cat


def job_cat_step(inp, mesh) -> Dict:
    """One CAT train step over the (dp, tp) mesh: this dp group's rows of
    the global batch and of the conditioning keep mask, the GPT split over
    tp; the loss and the gathered GPT; and the trainer's lr at this world
    for `inp["batch_size"]` a rank."""
    from favae_tpu_torch.parallel.sharding import gather_gpt_state, shard_gpt_
    from favae_tpu_torch.train import cat_step
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    cfg, lr = inp["cfg"], inp["lr"]
    cat = _cat(inp)
    shard_gpt_(cat.gpt, mesh.tp)
    state = cat_step.CATTrainState(cat=cat, opt=cat_step.CATAdamW(cat.gpt, cfg),
                                   lr_schedule=lambda i: lr)
    step = cat_step.make_cat_train_step(dp=mesh.dp)

    def rows(a):
        return torch.from_numpy(a).chunk(mesh.dp.size)[mesh.dp.rank]

    state, m = step(state, rows(inp["x"]), rows(inp["ids"]).long(), None,
                    cond_keep=rows(inp["keep"]))
    full = gather_gpt_state(cat.gpt.state_dict(), mesh.tp)
    trainer = CATTrainer(cfg, inp["save_dir"], steps_per_epoch=10,
                         batch_size=inp["batch_size"], device="cpu",
                         cat=_cat(inp), mesh=mesh)
    return {"loss": float(m["loss_gpt"]), "gpt": _np_sd(full),
            "lr": trainer.lr,
            "schedule": [trainer.lr_schedule(i) for i in range(12)]}


def job_cat_cli(inp, mesh) -> Dict:
    """`cli.train_cat.main` under this launch (its own process group); the
    trainer's gathered state after the run."""
    from favae_tpu_torch.cli import train_cat
    from favae_tpu_torch.train import cat_trainer
    seen = {}
    fit = cat_trainer.CATTrainer.fit

    def keep(self, *a, **k):
        fit(self, *a, **k)
        seen["state"] = self.state_dict()
        seen["shard_rows"] = self.state.opt.params[0].shape

    cat_trainer.CATTrainer.fit = keep
    out = train_cat.main(inp["argv"], cfg=inp["cfg"])
    sd = seen["state"]
    return {"history": out["history"], "val": out["val"], "lr": out["lr"],
            "gpt": _np_sd(sd["gpt"]),
            "mu": [t.numpy().copy() for t in sd["opt"]["mu"]],
            "nu": [t.numpy().copy() for t in sd["opt"]["nu"]],
            "step": sd["step"]}


def job_gpt_sample_tp(inp, mesh) -> Dict:
    """`GPT.sample` on this rank's tp slice of an f32 GPT under injected
    gumbel noise, every call into `ops.ln_fused` and of the split middle
    norm counted: the tokens, the counts and the kernel's launches."""
    from favae_tpu_torch.models import gpt as tgpt
    from favae_tpu_torch.ops import ln_fused
    from favae_tpu_torch.parallel.sharding import shard_gpt_
    gpt = tgpt.GPT(inp["cfg"], dtype=torch.float32).eval()
    gpt.load_state_dict({k: torch.from_numpy(v) for k, v in inp["gpt"].items()})
    shard_gpt_(gpt, mesh.tp)
    calls = {}
    for mod, name in ((ln_fused, "add_ln"), (ln_fused, "gelu_ln"),
                      (ln_fused, "add_ln_plain"), (ln_fused, "gelu_ln_plain"),
                      (tgpt, "split_layer_norm")):
        calls[name] = 0

        def counted(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        setattr(mod, name, counted)
    launches = ln_fused.LAUNCHES["add_ln"]
    tokens = gpt.sample(inp["te"], inp["tm"], gumbel_noise=inp["noise"],
                        **inp["kw"])
    return {"tokens": tokens, "calls": calls,
            "launches": ln_fused.LAUNCHES["add_ln"] - launches}


def job_favae_cli(inp, mesh) -> Dict:
    """`cli.train_favae.main` under this launch."""
    from favae_tpu_torch.cli import train_favae
    out = train_favae.main(inp["argv"])
    return {"history": out["history"], "val": out["val"], "lr": out["lr"]}


JOBS = {"favae_step": job_favae_step, "favae_init": job_favae_init,
        "cat_step": job_cat_step, "cat_cli": job_cat_cli,
        "favae_cli": job_favae_cli, "gpt_sample_tp": job_gpt_sample_tp}
# the jobs that start their own process group (through a CLI)
CLI_JOBS = ("cat_cli", "favae_cli")


def main(job: str, src: str, dst: str) -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(src, weights_only=False)
    mesh = None
    if job not in CLI_JOBS:
        from favae_tpu_torch.parallel.mesh import init_distributed, make_mesh
        init_distributed("gloo")
        mesh = make_mesh(inp.get("tp", 1), "cpu")
    out = JOBS[job](inp, mesh)
    torch.save(out, dst)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
