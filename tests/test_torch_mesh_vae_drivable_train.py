"""Parity of one drivable mesh-VAE training step of the port with the JAX
package on the CPU, at the sizes of tests/test_mesh_vae_drivable.py with
PoseToShadow and the loss set of tests/test_torch_mesh_vae_train.py: every
loss term and every parameter gradient, through the rasterizer's
edge-gradient backward; the frozen face decoder's zero gradients, and its
parameters unchanged by one update of the optimizer in both packages; the
JAX optimizer state taken by ``opt_state_from_jax``. Also the training
draws and the fields the drivable encoders refuse.

As in tests/test_torch_mesh_vae_train.py, both sides take the jittered
template, the port's initialization put into the JAX tree by name, and
``noise_std=0`` in both encoders (the two packages cannot draw the same
random numbers); the JAX step runs under ``jax.jit``.

Tolerances: losses rtol 1e-4 (float32 sums in other orders). Parameter
gradients rtol 1e-3 plus atol 1e-3 of the parameter's largest |reference|
gradient entry (float32 convolution and scatter gradients summed over the
texture, the render and the edge pairs in other orders). The face
decoder's gradients and its parameters' moves are exactly 0 in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from goliath_torch.convert import opt_state_from_jax, params_from_jax
from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.models.mesh_vae_drivable import AutoEncoder as TAutoEncoder
from goliath_torch.optim import build_optimizer as t_build_optimizer
from goliath_torch.test import to_device
from goliath_tpu import optim as j_optim
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.models.mesh_vae_drivable import AutoEncoder as JAutoEncoder
from tests.drivable_fixture import (
    dataset,
    drivable_batch,
    jax_params,
    model_kw,
)
from tests.test_torch_mesh_vae_train import ITERATION, LOSSES

torch.set_num_threads(1)

CPU = torch.device("cpu")
OPT = {"class_name": "goliath_tpu.optim.Adam", "lr": 1e-3}


def _frozen(names):
    return [n for n in names if n.startswith("decoder_face.")]


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's train=True forward, losses and gradients, and one
    update of its optimizer (scrub, clip, Adam) from them."""
    ds = dataset()
    kw = model_kw(ds, noise_std=0.0)
    batch = drivable_batch(ds)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JAutoEncoder(**kw)
    state = TAutoEncoder(**kw, device="cpu").module.state_dict()
    state["pixel_cal.bias"] = torch.from_numpy(np.random.RandomState(3).randn(
        *state["pixel_cal.bias"].shape).astype(np.float32))
    params = jax_params(jm, jb, state)
    loss_fn = JModularLoss(LOSSES, assets=ds.static_assets)

    def loss_inner(p):
        preds = jm.apply(p, jb, train=True,
                         rngs={"noise": jax.random.PRNGKey(3)})
        total, ldict = loss_fn(preds, jb, ITERATION)
        return total, ldict

    (total, ldict), grads = jax.jit(jax.value_and_grad(
        loss_inner, has_aux=True))(params)
    opt = j_optim.build_optimizer(OPT, params)

    @jax.jit
    def update(grads, params):
        updates, opt_state = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates), opt_state

    new_params, opt_state = update(grads, params)
    return dict(
        ds=ds, batch=batch, params=jax.device_get(params),
        total=float(total), ldict={k: float(v) for k, v in ldict.items()},
        grads=jax.device_get(grads), new_params=jax.device_get(new_params),
        adam=jax.device_get(opt_state[2][0]))


def test_train_step_matches_jax_and_the_face_decoder_stays(jax_step):
    ds = jax_step["ds"]
    tm = TAutoEncoder(**model_kw(ds, noise_std=0.0), device="cpu")
    tm.module.load_state_dict(params_from_jax(jax_step["params"]),
                              strict=True)
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    loss_fn = TModularLoss(LOSSES, assets=ds.static_assets)
    optimizer = t_build_optimizer(OPT, tm.module)
    optimizer.zero_grad()
    tb = to_device(jax_step["batch"], CPU)
    preds = tm.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, ITERATION)
    total.backward()

    assert "face_dec_preds" in preds and "pose_shadow_map" in preds
    assert set(ldict) == set(jax_step["ldict"])
    np.testing.assert_allclose(total.item(), jax_step["total"], rtol=1e-4)
    for k, ref in jax_step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=1e-4,
                                   atol=1e-9, err_msg=k)

    ref_grads = params_from_jax(jax_step["grads"])
    named = dict(tm.module.named_parameters())
    assert set(named) == set(ref_grads)
    frozen = _frozen(named)
    assert len(frozen) == 22
    for name, p in named.items():
        r = ref_grads[name].numpy()
        assert np.isfinite(r).all(), name
        if name in frozen:
            # JAX stops the gradient at the decoder's outputs: zeros; the
            # port runs it without a graph: no gradient at all
            assert not r.any() and p.grad is None, name
            continue
        assert p.grad is not None and p.grad.shape == r.shape, name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)
    for top in ("decoder", "encoder", "encoder_face", "decoder_view",
                "upscale_net", "pose_to_shadow"):
        assert any(float(p.grad.abs().max()) > 0
                   for n, p in named.items() if n.startswith(top + ".")), top

    # one update: the face decoder's parameters stay where they are in
    # both packages; the others move (but where a tiny gradient's step of
    # ~lr * g / eps rounds away against the parameter)
    optimizer.step()
    after = tm.module.state_dict()
    new_ref = params_from_jax(jax_step["new_params"])
    moved = {"port": 0, "jax": 0}
    for name in named:
        moves = {"port": not torch.equal(after[name], before[name]),
                 "jax": not torch.equal(new_ref[name], before[name])}
        if name in frozen:
            assert not any(moves.values()), name
        for k, v in moves.items():
            moved[k] += v
    n_free = len(named) - len(frozen)
    assert all(v >= 0.9 * n_free for v in moved.values()), (moved, n_free)

    # the JAX optimizer state of this tree, the frozen moments included
    adam = jax_step["adam"]
    assert int(adam.count) == 1
    opt_state_from_jax(optimizer, tm.module, mu=adam.mu, nu=adam.nu,
                       count=int(adam.count))
    for name, p in named.items():
        st = optimizer.inner.state[p]
        assert float(st["step"]) == 1.0
        if name in frozen:
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    assert any(optimizer.inner.state[named[n]]["exp_avg"].any()
               for n in named if n not in frozen)


def test_training_draws_come_from_the_generator(jax_step):
    """noise_std=1: each encoder's noise has its latent's shape and unit
    scale; the same generator seed gives the same draws, another seed
    others; a given noise is used as it is; eval draws nothing."""
    ds, batch = jax_step["ds"], to_device(jax_step["batch"], CPU)

    def preds(seed, **extra):
        tm = TAutoEncoder(**model_kw(ds, noise_std=1.0), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm, tm.apply({**batch, **extra}, train=True)

    _, p_a = preds(5)
    _, p_b = preds(5)
    tm, p_c = preds(6)
    for prefix, n in (("", 16), ("face_", 8)):
        embs, mu, logvar = (p_a[f"{prefix}embs{s}"]
                            for s in ("", "_mu", "_logvar"))
        assert torch.equal(embs, p_b[f"{prefix}embs"])
        assert not torch.equal(embs, p_c[f"{prefix}embs"])
        noise = (embs - mu) / torch.exp(logvar)
        assert noise.shape == (2, n)
        assert 0.4 < float(noise.std()) < 1.8, prefix
    given = {"noise": torch.full((2, 16), 0.25),
             "face_noise": torch.full((2, 8), -0.5)}
    with torch.no_grad():
        p = tm.apply({**batch, **given}, train=True)
        ev = tm.apply(batch, train=False)
    for prefix, key in (("", "noise"), ("face_", "face_noise")):
        torch.testing.assert_close(
            p[f"{prefix}embs"], p[f"{prefix}embs_mu"]
            + torch.exp(p[f"{prefix}embs_logvar"]) * given[key])
        assert torch.equal(ev[f"{prefix}embs"], ev[f"{prefix}embs_mu"])
    assert "pose_shadow_map" not in ev


def test_drivable_encoders_refuse_the_mesh_vae_fields(jax_step):
    """mesh_vae's ``verts_scale`` and ``mean_scale`` are not fields of the
    drivable encoders: both packages refuse them (TypeError)."""
    ds, batch = jax_step["ds"], jax_step["batch"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for field in ("verts_scale", "mean_scale"):
        kw = model_kw(ds)
        kw["encoder"] = dict(kw["encoder"], **{field: 0.01})
        with pytest.raises(TypeError, match=field):
            TAutoEncoder(**kw, device="cpu")
        with pytest.raises(TypeError, match=field):
            jax.eval_shape(JAutoEncoder(**kw).init, jax.random.PRNGKey(0),
                           jb)
