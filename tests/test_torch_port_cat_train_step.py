"""The port's CAT optimizer, schedule and train step against
`favae_tpu.train.{cat_step,schedule}`, on the CPU in f32.

- `make_step_schedule` equals JAX's f32 values over 50 updates (1e-7
  relative; both compute in f32 in the same order).
- `decay_mask` decays the same parameters, name for name, as JAX's mask
  carried through `gpt_from_jax`.
- `CATAdamW` against `make_cat_optimizer` on three identical gradient
  sequences: with f32 moments the parameters agree to 1e-6; with bf16
  moments both sides round the same f32 moments, and a rounding that lands
  the other way moves a parameter by at most lr * 2^-8: bound lr * 2^-7.
- The full-pipeline step (frozen FA-VAE and CLIP encodes, GPT loss,
  AdamW) against `make_cat_train_step` at dropout 0 with JAX's
  conditioning keep mask handed over, from one state: the loss within
  1e-4 relative, the parameters within 2.1 lr at most and 1e-3 lr on
  average (Adam's first steps move each parameter by about lr * sign(g),
  and a gradient within rounding of zero may take either sign). Before the
  second step the port takes JAX's parameters and moments, as
  tests/test_torch_port_train.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from favae_tpu.train.cat_step import (create_cat_state, decay_mask,
                                      make_cat_optimizer, make_cat_train_step)
from favae_tpu.train.schedule import make_step_schedule as jax_schedule
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.train import cat_step
from favae_tpu_torch.train.schedule import make_step_schedule
from tests.cat_train_common import (batch, both_cats, jax_keep, np_tree,
                                    port_gpt, tiny_cfg)

LR = 1e-3


@pytest.mark.parametrize("kw", [
    dict(warmup_epochs=2, epochs=5, lr=3.2e-5, min_lr=1e-6),
    dict(warmup_epochs=1, epochs=5, lr=1e-3),
    dict(warmup_epochs=2, epochs=5, lr=1e-3, enabled=False)])
def test_step_schedule_matches_jax(kw):
    ref, ours = jax_schedule(10, **kw), make_step_schedule(10, **kw)
    assert ours(0) == (0.0 if kw.get("enabled", True) else
                       float(np.float32(kw["lr"])))
    for i in range(50):
        want = float(ref(jnp.int32(i)))
        assert abs(ours(i) - want) <= 1e-7 * abs(want), i


@pytest.fixture(scope="module")
def cats():
    return both_cats()


def test_decay_mask_matches_jax(cats):
    _, params, ours, _ = cats
    full = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m),
                                  decay_mask(params), np_tree(params))
    ref = {k: bool(v.flatten()[0]) for k, v in gpt_from_jax(full).items()}
    assert cat_step.decay_mask(ours.gpt) == ref
    off = sorted(k for k, v in ref.items() if not v)
    assert off == ["blocks.0.0.rel_pos_bias.pos_bias.weight",
                   "blocks.1.0.rel_pos_bias.pos_bias.weight",
                   "tok_emb.weight"]


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*np.shape(p)) * 0.01).astype(np.float32), params)


@pytest.mark.parametrize("mu,nu,bound", [
    ("float32", "float32", 1e-6), ("bfloat16", "float32", LR * 2 ** -7),
    ("bfloat16", "bfloat16", LR * 2 ** -7)])
def test_adamw_matches_make_cat_optimizer(cats, mu, nu, bound):
    _, params, _, _ = cats
    cfg = tiny_cfg(tcfg, adam_mu_dtype=mu, adam_nu_dtype=nu)
    from favae_tpu import config as jcfg
    tx = make_cat_optimizer(tiny_cfg(jcfg, adam_mu_dtype=mu,
                                     adam_nu_dtype=nu),
                            optax.constant_schedule(LR))
    state = tx.init(params)
    gpt = port_gpt(cfg, params)
    opt = cat_step.CATAdamW(gpt, cfg)
    assert {m.dtype for m in opt.mu} == {getattr(torch, mu)}
    assert {v.dtype for v in opt.nu} == {getattr(torch, nu)}
    p = params
    for i in range(3):
        g = _grads(params, 10 + i)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        tg = gpt_from_jax(g)
        for name, t in zip(opt.names, opt.params):
            t.grad = tg[name]
        opt.step(LR)
    want = gpt_from_jax(np_tree(p))
    for name, t in gpt.named_parameters():
        err = (t.detach() - want[name]).abs().max().item()
        assert err <= bound, f"{name}: {err}"


def _give_jax_state(jstate, state):
    """The port's GPT and AdamW take JAX's parameters and moments."""
    adam = jstate.opt_state[0]
    sd = gpt_from_jax(np_tree(jstate.gpt_params))
    mu, nu = gpt_from_jax(np_tree(adam.mu)), gpt_from_jax(np_tree(adam.nu))
    opt = state.opt
    with torch.no_grad():
        for i, name in enumerate(opt.names):
            opt.params[i].copy_(sd[name])
            opt.mu[i].copy_(mu[name])
            opt.nu[i].copy_(nu[name])
    opt.count = state.step = int(jstate.step)


@pytest.mark.parametrize("steps", [1, 2])
def test_full_pipeline_steps_match_jax(cats, steps):
    jmodel, params, ours, cfg = cats
    from favae_tpu import config as jcfg
    tx = make_cat_optimizer(tiny_cfg(jcfg), optax.constant_schedule(LR))
    jstate = create_cat_state(jmodel, params, tx)
    jstep = jax.jit(make_cat_train_step(jmodel, tx))
    ours.gpt = port_gpt(cfg, params)
    state = cat_step.CATTrainState(cat=ours,
                                   opt=cat_step.CATAdamW(ours.gpt, cfg),
                                   lr_schedule=lambda i: LR)
    step = cat_step.make_cat_train_step()
    rng = jax.random.PRNGKey(5)
    frozen = jmodel.frozen_params()
    for i in range(steps):
        x, ids = batch(seed=20 + i)
        if i:
            _give_jax_state(jstate, state)
        jstate, jm = jstep(jstate, frozen, jnp.asarray(x), jnp.asarray(ids),
                           rng)
        keep = jax_keep(rng, i, 4)
        state, m = step(state, torch.from_numpy(x),
                        torch.from_numpy(ids).long(), None, cond_keep=keep)
        ref_loss, loss = float(jm["loss_gpt"]), float(m["loss_gpt"])
        assert abs(loss - ref_loss) <= 1e-4 * ref_loss, (i, loss, ref_loss)
        want = gpt_from_jax(np_tree(jstate.gpt_params))
        errs = torch.cat([(p.detach() - want[n]).abs().flatten() / LR
                          for n, p in ours.gpt.named_parameters()])
        assert errs.max().item() <= 2.1, (i, errs.max().item())
        assert errs.mean().item() <= 1e-3, (i, errs.mean().item())
    assert state.step == steps


def test_grad_accum_needs_a_divisible_batch(cats):
    _, _, ours, cfg = cats
    state = cat_step.CATTrainState(cat=ours,
                                   opt=cat_step.CATAdamW(ours.gpt, cfg),
                                   lr_schedule=lambda i: LR)
    x, ids = batch()
    with pytest.raises(ValueError, match="not divisible"):
        cat_step.make_cat_train_step(grad_accum=3)(
            state, torch.from_numpy(x), torch.from_numpy(ids).long(),
            torch.Generator())
