"""The port's losses, optimizers and LR schedules against the JAX package,
on the CPU, from the same numpy inputs.

Losses: value and gradient with respect to the logits, with invalid rows,
a class that never occurs and a class weight. Optimizers: all five names
over three updates of a two-group parameter tree (one group named
``sphereformer...``, one not) under a cosine schedule, against optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import schedulers as jax_schedulers

from u2mkd_tpu_torch.ops import losses
from u2mkd_tpu_torch.train import optim, schedulers

N, C = 300, 6


def _loss_inputs(rng):
    logits = (rng.randn(N, C) * 2).astype(np.float32)
    labels = rng.randint(0, C - 1, N).astype(np.int32)   # class C-1 never occurs
    labels[:5] = C + 3                                    # out of range: clipped by CE
    valid = rng.rand(N) < 0.8
    valid[:5] = False
    weight = rng.uniform(0.5, 2.0, C).astype(np.float32)
    other = (rng.randn(N, C) * 2).astype(np.float32)
    return logits, labels, valid, weight, other


# name -> (JAX loss, port loss) of (logits, labels, valid, weight, other)
CASES = {
    "lovasz_softmax": (lambda x, y, m, w, o: jax_losses.lovasz_softmax(x, y, m),
                       lambda x, y, m, w, o: losses.lovasz_softmax(x, y, m)),
    "cross_entropy": (lambda x, y, m, w, o: jax_losses.cross_entropy(x, y, m),
                      lambda x, y, m, w, o: losses.cross_entropy(x, y, m)),
    "cross_entropy_weighted": (lambda x, y, m, w, o: jax_losses.cross_entropy(x, y, m, w),
                               lambda x, y, m, w, o: losses.cross_entropy(x, y, m, w)),
    "lovasz_ce_weighted": (lambda x, y, m, w, o: jax_losses.lovasz_ce(x, y, m, w),
                           lambda x, y, m, w, o: losses.lovasz_ce(x, y, m, w)),
    "kl_div_batchmean": (lambda x, y, m, w, o: jax_losses.kl_div_batchmean(x, o, m),
                         lambda x, y, m, w, o: losses.kl_div_batchmean(x, o, m)),
    "masked_mse": (lambda x, y, m, w, o: jax_losses.masked_mse(x, o, m),
                   lambda x, y, m, w, o: losses.masked_mse(x, o, m)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(rng, name):
    """Value and d/dlogits. f32 sums over 300 rows (and the Lovász cumsums)
    in another order: a few ulps, well inside 1e-5."""
    logits, labels, valid, weight, other = _loss_inputs(rng)
    jax_fn, port_fn = CASES[name]
    ref, ref_grad = jax.value_and_grad(jax_fn)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(weight),
        jnp.asarray(other))
    x = torch.from_numpy(logits).requires_grad_()
    out = port_fn(x, torch.from_numpy(labels).long(), torch.from_numpy(valid),
                  torch.from_numpy(weight), torch.from_numpy(other))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5, atol=1e-6)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_grad).max())
    assert not x.grad.numpy()[~valid].any()  # masked rows get no gradient


def test_lovasz_ties_keep_index_order():
    """Equal errors keep their index order in the descending sort (JAX's
    stable argsort of -e): two rows of one class with identical
    probabilities, one foreground and one not, give the JAX loss."""
    logits = np.zeros((4, 3), np.float32)
    labels = np.array([1, 0, 2, 1], np.int32)
    valid = np.ones(4, bool)
    ref = float(jax_losses.lovasz_softmax(jnp.asarray(logits), jnp.asarray(labels),
                                          jnp.asarray(valid)))
    out = losses.lovasz_softmax(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                                torch.from_numpy(valid)).item()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("world_size", [1, 4])
def test_schedules_match_jax(world_size):
    """The JAX cosine runs in f32 (jnp.cos), the port's in f64: 1e-7
    absolute, f32 resolution of a factor in [0, 1]."""
    cos_ref = jax_schedulers.cosine_schedule_with_warmup(3, 2, 1000, world_size)
    cos = schedulers.cosine_schedule_with_warmup(3, 2, 1000, world_size)
    poly_ref, poly = jax_schedulers.poly_lr(900), schedulers.poly_lr(900)
    for step in (0, 1, 7, 249, 250, 251, 600, 1499):
        np.testing.assert_allclose(cos(step), float(cos_ref(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7)
    for step in (0, 1, 7, 250, 600, 900):
        np.testing.assert_allclose(poly(step), float(poly_ref(step)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", optim.NAMES)
def test_optimizer_matches_optax(rng, name):
    """Three updates with random gradients under a cosine schedule at lr
    0.02 and weight decay 0.05 (large enough to matter): every parameter,
    both groups, after every step. Parameters are f32 on both sides, but
    optax evaluates the schedule and Adam's bias corrections in f32 where
    torch takes them in f64 on the host; Adam moves each parameter by ~lr
    per step whatever the gradient, so the two agree to ~1e-6 absolute."""
    sched = schedulers.cosine_schedule_with_warmup(1, 1, 5)
    jax_sched = jax_schedulers.cosine_schedule_with_warmup(1, 1, 5)
    params = {"sphereformer1": {"w": rng.randn(3, 4).astype(np.float32)},
              "head": {"w": rng.randn(5).astype(np.float32),
                       "b": rng.randn(2).astype(np.float32)}}
    tx = jax_optim.make_optimizer(name, lambda s: 0.02 * jax_sched(s), weight_decay=0.05)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    named = {f"{a}.{b}": torch.nn.Parameter(torch.from_numpy(v.copy()))
             for a, sub in params.items() for b, v in sub.items()}
    opt, lr_sched = optim.make_optimizer(named.items(), name, lambda s: 0.02 * sched(s),
                                         weight_decay=0.05)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for key, p in named.items():
            a, b = key.split(".")
            p.grad = torch.from_numpy(grads[a][b])
        opt.step()
        lr_sched.step()
        for key, p in named.items():
            a, b = key.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[a][b]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    moved = {k: np.abs(p.detach().numpy() - params[k.split(".")[0]][k.split(".")[1]]).max()
             for k, p in named.items()}
    assert min(moved.values()) > 0


def test_spformer_group_takes_the_scaled_lr():
    named = [("sphereformer2.attn.qkv.weight", torch.nn.Parameter(torch.zeros(2))),
             ("stem0.conv0.kernel", torch.nn.Parameter(torch.zeros(3)))]
    opt, sched = optim.make_optimizer(named, "sgd_spformer", 0.02)
    assert sched is None
    lrs = sorted(g["lr"] for g in opt.param_groups)
    np.testing.assert_allclose(lrs, [0.002, 0.02])
    assert all(g["weight_decay"] == 1e-4 for g in opt.param_groups)
    opt, _ = optim.make_optimizer(named, "sgd", 0.02)
    assert len(opt.param_groups) == 1
