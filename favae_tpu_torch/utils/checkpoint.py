"""Checkpoints of a train state: atomic latest/best directories of torch
files (port of favae_tpu/utils/checkpoint.py; reference: utils.py:108-119
and favae_scripts/train_favae.py:363-382).

A checkpoint is a directory holding `state.pt` (the state as a nested dict
of tensors and numbers, written by `torch.save`), `host_meta.json` (epoch,
score, best score) and `_COMMITTED`, written last. The semantics are the
JAX package's; only the storage changes, from Orbax to `torch.save`.

In a run of several processes only rank 0 writes (the state is equal on
every rank, or gathered to full tensors by the caller), and every rank
waits for the write at a barrier; every rank reads on resume.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from favae_tpu_torch.parallel.mesh import barrier, is_main_process

STATE_FILE = "state.pt"
NOT_A_PORT_CHECKPOINT = (
    "{path} holds no " + STATE_FILE + ", so it is not a favae_tpu_torch "
    "checkpoint. An Orbax checkpoint of favae_tpu does not load here: run "
    "`python -m favae_tpu.cli.export_torch` on it where JAX is installed, "
    "and pass the .pt it writes to --torch_ckpt (eval_favae), "
    "--torch_cat_ckpt (generate) or --resume_path (train_favae, "
    "train_cat).")


def _meta_path(path: str) -> str:
    return os.path.join(path, "host_meta.json")


def _commit_path(path: str) -> str:
    return os.path.join(path, "_COMMITTED")


def to_host(tree: Any) -> Any:
    """The same nested dicts, lists and tuples with every tensor detached
    and on the CPU (a copy of each device tensor; CPU tensors as they
    are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: Any, meta: Optional[Dict] = None
                    ) -> None:
    """Crash-safe write of `state` + host metadata to the directory `path`.

    At every instant a restorable checkpoint exists: the full checkpoint
    goes to ``path + ".tmp"`` first (complete once ``_COMMITTED``, written
    last, exists), then swaps in by two renames. A crash at any point
    leaves a valid ``path``, a committed ``path.tmp`` or the previous
    ``path.old``, and `CheckpointManager.try_resume` uses each.
    """
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(to_host(state), os.path.join(tmp, STATE_FILE))
    if meta is not None:
        with open(_meta_path(tmp), "w") as f:
            json.dump(meta, f)
    with open(_commit_path(tmp), "w") as f:
        f.write("ok")
    old = path + ".old"
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_checkpoint(path: str, device=None) -> Tuple[Any, Dict]:
    """(state, meta) of the checkpoint directory `path`, its tensors loaded
    with `weights_only=True` onto `device` (where they were saved, the CPU,
    when None). Raises for a directory without `state.pt`, such as an
    Orbax checkpoint, naming the route from one."""
    path = os.path.abspath(path)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(state_file):
        raise FileNotFoundError(NOT_A_PORT_CHECKPOINT.format(path=path))
    state = torch.load(state_file, map_location=device, weights_only=True)
    meta: Dict = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return state, meta


class CheckpointManager:
    """latest/best policy of the reference trainer
    (train_favae.py:363-382); `device` is where restores load to. Only
    rank 0 (`writer`) writes or renames; the others wait at a barrier."""

    def __init__(self, save_dir: str, save_every_epoch: int = 1,
                 device=None):
        self.save_dir = os.path.abspath(save_dir)
        self.save_every_epoch = save_every_epoch
        self.device = device
        self.best_score = float("inf")
        self.writer = is_main_process()
        os.makedirs(self.save_dir, exist_ok=True)

    @property
    def latest_path(self):
        return os.path.join(self.save_dir, "latest")

    @property
    def best_path(self):
        return os.path.join(self.save_dir, "best")

    def due(self, epoch: int, is_last: bool = False) -> bool:
        """Whether `on_epoch_end` writes after `epoch` (a trainer whose
        state is costly to assemble asks first)."""
        return self.save_every_epoch > 0 and (
            epoch % self.save_every_epoch == 0 or is_last)

    def on_epoch_end(self, epoch: int, score: float, state: Any,
                     is_last: bool = False) -> None:
        """Persist latest (and best-so-far) on cadence epochs.

        With ``save_every_epoch=1``: latest every epoch, best whenever the
        score improves (so a run without validation, score inf, never
        writes best). A sparser cadence writes both only on cadence epochs
        and the final one, and best is then the best of the persisted
        epochs. ``save_every_epoch=0`` (a port-only value) writes nothing:
        for smoke runs and measurements. The state is copied to the host
        once for both writes.
        """
        if not self.due(epoch, is_last):
            return
        meta = {"epoch": epoch + 1, "score": score,
                "best_score": min(self.best_score, score)}
        best = score < self.best_score
        if best:
            self.best_score = score
        if self.writer:
            state = to_host(state)
            save_checkpoint(self.latest_path, state, meta)
            if best:
                save_checkpoint(self.best_path, state, meta)
        barrier()

    def try_resume(self) -> Tuple[Any, Dict]:
        """(state, meta) of the newest restorable checkpoint, or (None, {}).

        Fallback order covers every crash window of `save_checkpoint`:
        ``latest``, then a committed ``latest.tmp`` (died between the two
        renames), then ``latest.old`` (died before the new write
        committed); the one chosen is renamed back to ``latest`` first.
        """
        if self.writer and not os.path.isdir(self.latest_path):
            tmp = self.latest_path + ".tmp"
            old = self.latest_path + ".old"
            if os.path.isdir(tmp) and os.path.exists(_commit_path(tmp)):
                os.rename(tmp, self.latest_path)
            elif os.path.isdir(old):
                os.rename(old, self.latest_path)
        barrier()
        if os.path.isdir(self.latest_path):
            state, meta = restore_checkpoint(self.latest_path, self.device)
            self.best_score = meta.get("best_score", float("inf"))
            return state, meta
        return None, {}
