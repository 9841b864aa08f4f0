"""The port's CAT losses and cached-latent path, on the CPU in f32.

- `gpt_loss` and `gpt_loss_from_latents` against the JAX package's, from
  the same weights and inputs (dropout 0, JAX's conditioning keep mask
  handed over in training; the eval loss keeps every text): within 1e-5
  relative, and the frozen encode's token ids equal.
- Held in the port itself, as tests/test_cat_latent_cache.py holds them
  for JAX: a step over cached latents equals the full step (dropout 0.1,
  one generator seed; loss and parameters bit for bit, since the latents
  come from an encode of the same batch); `grad_accum=2` gives the full
  batch's loss within 1e-4 and its grads within rtol 2e-2 / atol 2e-3 of
  the largest grad (JAX's own bounds; dropout and conditioning dropout
  off, so only the order of the sums differs); `precompute_latents` pads
  the tail batch and trims it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu_torch.data.latent_cache import precompute_latents
from favae_tpu_torch.data.pipeline import SyntheticDataset
from favae_tpu_torch.train import cat_step
from tests.cat_train_common import batch, both_cats, port_cat

LR = 1e-3


@pytest.fixture(scope="module")
def cats():
    return both_cats(seed=1)


@pytest.mark.parametrize("train", [True, False])
def test_gpt_losses_match_jax(cats, train):
    jmodel, params, ours, _ = cats
    x, ids = batch(seed=3)
    key = jax.random.PRNGKey(9)
    keep = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, 17), (4,)) < 0.75))

    @jax.jit
    def reference(params, frozen, x, ids):
        loss = jmodel.gpt_loss(params, x, ids, rng=key, train=train,
                               frozen=frozen)
        z = jmodel.encode_to_z(x, frozen["favae_variables"],
                               frozen["cb_state"])
        e, m = jmodel.encode_text_ids(ids, frozen["clip_params"])
        return loss, z, jmodel.gpt_loss_from_latents(params, z, e, m,
                                                     rng=key, train=train)

    ref, z_ref, ref_lat = reference(params, jmodel.frozen_params(),
                                    jnp.asarray(x), jnp.asarray(ids))
    ref, ref_lat, z_ref = float(ref), float(ref_lat), np.asarray(z_ref)
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids).long()
    z = ours.encode_to_z(tx)
    np.testing.assert_array_equal(z.numpy(), z_ref)
    kw = dict(train=train, cond_keep=keep if train else None)
    with torch.no_grad():
        loss = ours.gpt_loss(tx, tids, **kw).item()
        e, m = ours.encode_text_ids(tids)
        loss_lat = ours.gpt_loss_from_latents(z, e, m, **kw).item()
    assert abs(loss - ref) <= 1e-5 * ref
    assert abs(loss_lat - ref_lat) <= 1e-5 * ref_lat
    assert loss == loss_lat


def _state(ours, cfg, sd):
    ours.gpt.load_state_dict(sd)
    return cat_step.CATTrainState(cat=ours,
                                  opt=cat_step.CATAdamW(ours.gpt, cfg),
                                  lr_schedule=lambda i: LR)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_latent_step_matches_full_step(grad_accum):
    ours, cfg = port_cat(dropout=0.1)
    params = {k: v.clone() for k, v in ours.gpt.state_dict().items()}
    x, ids = batch(seed=4)
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids).long()
    z = ours.encode_to_z(tx)
    embeds, mask = ours.encode_text_ids(tids)
    full = _state(ours, cfg, params)
    _, m_full = cat_step.make_cat_train_step(grad_accum)(
        full, tx, tids, torch.Generator().manual_seed(3))
    after_full = {k: v.detach().clone()
                  for k, v in full.cat.gpt.named_parameters()}
    lat = _state(ours, cfg, params)
    _, m_lat = cat_step.make_cat_latent_train_step(grad_accum)(
        lat, z, embeds, mask, torch.Generator().manual_seed(3))
    assert m_full["loss_gpt"].item() == m_lat["loss_gpt"].item()
    for k, v in lat.cat.gpt.named_parameters():
        assert torch.equal(v.detach(), after_full[k]), k
    with torch.no_grad():
        assert torch.equal(cat_step.cat_eval_step(lat, tx, tids)["loss_gpt"],
                           cat_step.cat_latent_eval_step(
                               lat, z, embeds, mask)["loss_gpt"])


def test_grad_accum_matches_full_batch():
    ours, cfg = port_cat(cond_drop_prob=0.0)
    params = {k: v.clone() for k, v in ours.gpt.state_dict().items()}
    x, ids = batch(seed=5)
    args = (torch.from_numpy(x), torch.from_numpy(ids).long(),
            torch.Generator().manual_seed(0))
    out = {}
    for ga in (1, 2, 4):
        state = _state(ours, cfg, params)
        _, m = cat_step.make_cat_train_step(ga)(state, *args)
        out[ga] = (m["loss_gpt"].item(),
                   [p.grad.clone() for p in state.opt.params])
    loss1, g1 = out[1]
    scale = max(g.abs().max().item() for g in g1)
    for ga in (2, 4):
        loss, g = out[ga]
        assert abs(loss - loss1) < 1e-4
        for a, b in zip(g1, g):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-2,
                                       atol=2e-3 * scale)


def test_precompute_latents_pads_the_tail_batch():
    ours, _ = port_cat()
    ds = SyntheticDataset(64, size=10, with_captions=True)
    cache = precompute_latents(ours, ds, batch_size=4, num_workers=1)
    assert len(cache) == 10 and cache.captions[9] == "synthetic caption 9"
    # the tail's encode saw samples 8, 9 and two copies of 9: the reference
    # is an encode of that same batch, so a batch composition that changes
    # the low bits cannot hide the pad-and-trim indexing under test
    (x8, cap8), (x9, cap9) = ds.get(8), ds.get(9)
    xs = torch.from_numpy(np.stack([x8, x9, x9, x9]))
    ids = ours.tokenize([cap8, cap9, cap9, cap9])
    z_ref = ours.encode_to_z(xs)
    e_ref, m_ref = ours.encode_text_ids(ids)
    for i, want in ((8, 0), (9, 1)):
        z, e, m, tid, cap = cache.get(i)
        np.testing.assert_array_equal(z, z_ref[want].numpy())
        np.testing.assert_array_equal(e, e_ref[want].numpy())
        np.testing.assert_array_equal(m, m_ref[want].numpy())
        np.testing.assert_array_equal(tid, ids[want].numpy())
        assert cap == (cap8, cap9)[want]
    first = precompute_latents(ours, SyntheticDataset(64, size=4,
                                                      with_captions=True),
                               batch_size=4, num_workers=1)
    np.testing.assert_array_equal(first.z, cache.z[:4])
