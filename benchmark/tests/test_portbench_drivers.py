"""Each driver at a tiny size on the CPU (the harness's look for a card
skipped): the port agrees with the reference within the cell's limits;
the control (the reference at the precision below the configuration's, in
the program's place) and each fault the cell can have, planted under the
timed path, come out not correct; and the run itself refuses to start
without a card. These are the only tests that import both the port and
the reference."""

import json

import pytest
import torch

from benchmark import run
from benchmark.harness import ROOT, load_json
from benchmark.tests.tiny import context, tiny_cat, tiny_cell, tiny_expe5

CELLS = {
    "expe5-train": lambda: tiny_cell("expe5-train", tiny_expe5(),
                                     "expe5-train"),
    "expe5-recon": lambda: tiny_cell("expe5-recon", tiny_expe5(),
                                     "expe5-recon", batch=2, keep_share=0.5,
                                     control_requests=2),
    "cat-gen": lambda: tiny_cell("cat-gen", tiny_cat(), "cat-gen", images=2,
                                 control_requests=1),
    "cat-train-cached": lambda: tiny_cell("cat-train-cached", tiny_cat(),
                                          "cat-train-cached", batch=2,
                                          img_steps=0),
}
BENCH_CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")
               ["workloads"]]
SEED = 2 ** 33 + 12345


def drive(cell, tmp_path, seed=SEED, during_setup=None, during_run=None,
          seconds=None):
    """setup, window and check of a run, with `during_setup` /
    `during_run` (context managers) around the first two."""
    from contextlib import nullcontext
    from benchmark.harness import driver_module
    drv = driver_module(cell.traffic["driver"])
    # cat-gen's window holds a greedy and a sampled request, however slow
    # the host
    ctx = context(cell, seed, tmp_path, seconds=seconds or 0.5,
                  min_items=2 if cell.name == "cat-gen" else 0)
    with during_run or nullcontext():
        with during_setup or nullcontext():
            st = drv.setup(ctx)
        win = drv.window(st, ctx)
    return win, drv.check(st, ctx)


@pytest.mark.parametrize("name", BENCH_CELLS)
def test_run_refuses_without_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", name, "--seed", "1", "--seconds", "1"]) \
        == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference(name, tmp_path):
    win, checks = drive(CELLS[name](), tmp_path)
    assert win.work >= 1
    assert all(c.ok for c in checks), checks


SEPARATED = [c for c in CELLS if c in BENCH_CELLS]


@pytest.mark.parametrize("name", SEPARATED)
def test_control_is_not_correct(name, tmp_path):
    from benchmark.harness import driver_module
    cell = CELLS[name]()
    drv = driver_module(cell.traffic["driver"])
    got = drv.control(context(cell, SEED, tmp_path))["control"]
    limits = cell.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits if k in got), got


class _Patch:
    def __init__(self, target, attr, make):
        self.target, self.attr, self.make = target, attr, make

    def __enter__(self):
        self.orig = getattr(self.target, self.attr)
        setattr(self.target, self.attr, self.make(self.orig))

    def __exit__(self, *exc):
        setattr(self.target, self.attr, self.orig)


def _unchanged(orig):
    return lambda self, *a, **k: None


def _half_batch_step(orig):
    def make(*a, **k):
        step = orig(*a, **k)
        return lambda state, x, *r, **kw: step(state, x[:x.shape[0] // 2],
                                               *r, **kw)
    return make


def _half_latent_step(orig):
    def make(*a, **k):
        step = orig(*a, **k)

        def half(state, z, embeds, mask, *r, **kw):
            n = z.shape[0] // 2
            return step(state, z[:n], embeds[:n], mask[:n], *r, **kw)
        return half
    return make


def _altered_code(orig):
    def reconstruct(self, x, *a, **k):
        x_recon, idx = orig(self, x, *a, **k)
        idx = idx.clone()
        idx.view(-1)[0] = (idx.view(-1)[0] + 1) % self.cfg.quantizer \
            .codebook_size
        return x_recon, idx
    return reconstruct


def _altered_token(orig):
    def sample_images(self, *a, **k):
        imgs, grid = orig(self, *a, **k)
        grid = grid.clone()
        grid.view(-1)[5] = (grid.view(-1)[5] + 1) % self.cfg.gpt.vocab_size
        return imgs, grid
    return sample_images


def faults():
    import favae_tpu_torch.train.adam as adam
    import favae_tpu_torch.train.cat_trainer as cat_trainer
    import favae_tpu_torch.train.favae_trainer as favae_trainer
    from favae_tpu_torch.models.txt_cond import CATModel
    from favae_tpu_torch.models.vqgan import VQGANFCM
    return {
        ("expe5-train", "state_unchanged"): (
            "setup", _Patch(torch.optim.Adam, "step", _unchanged)),
        ("expe5-train", "half_batch"): (
            "setup", _Patch(favae_trainer, "make_train_step",
                            _half_batch_step)),
        ("cat-train-cached", "state_unchanged"): (
            "setup", _Patch(adam.OptaxAdam, "step", _unchanged)),
        ("cat-train-cached", "half_batch"): (
            "setup", _Patch(cat_trainer, "make_cat_latent_train_step",
                            _half_latent_step)),
        ("expe5-recon", "answer_altered"): (
            "run", _Patch(VQGANFCM, "reconstruct", _altered_code)),
        ("cat-gen", "token_altered"): (
            "run", _Patch(CATModel, "sample_images", _altered_token)),
    }


FAULTS = [("expe5-train", "state_unchanged"), ("expe5-train", "half_batch"),
          ("cat-train-cached", "state_unchanged"),
          ("cat-train-cached", "half_batch"),
          ("expe5-recon", "answer_altered"), ("cat-gen", "token_altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, tmp_path):
    when, patch = faults()[(name, fault)]
    kw = {"during_setup" if when == "setup" else "during_run": patch}
    _, checks = drive(CELLS[name](), tmp_path, **kw)
    assert not all(c.ok for c in checks), checks


@pytest.mark.card
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_cell_on_the_card(name, card, capsys):
    assert run.main(["--workload", name, "--seed", str(SEED),
                     "--seconds", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
