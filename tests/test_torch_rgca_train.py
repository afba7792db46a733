"""Parity of one RGCA training step of the port with the JAX package on the
CPU (the Pallas kernels in interpret mode, the port's kernels through their
plain versions): the forward with ``train=True``, every loss term and every
parameter gradient at ``configs/rgca_synthetic.yml`` size, the backlit
branch, the training draws and the decoder recomputation.

The two packages cannot draw the same random numbers, so the step is
compared with ``encoder.noise_std=0`` (the noise is multiplied by 0 on both
sides), and the port is fed the backlit direction the JAX run drew,
recovered from its outputs (``cos_weight = light_dir . spec_nml`` is a
linear system in ``light_dir``).

Tolerances: losses rtol 1e-4 (float32 sums in other orders, as the eval
parity test). Parameter gradients rtol 1e-3 plus atol 1e-3 of the
parameter's largest gradient entry: they pass through the compositor
backward, whose per-prim sums are differences of float32 prefixes over the
pair budget on both sides, taken in other orders. Backlit outputs rtol 1e-4
/ atol 5e-5 (the direction fed to the port is a least-squares recovery).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.config import load_config as t_load_config
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import params_from_jax
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.models import rgca as t_rgca
from goliath_torch.ops import sg as t_sg
from goliath_torch.optim import build_optimizer
from goliath_torch.test import to_device
from goliath_torch.utils import geom as t_geom
from goliath_tpu.config import load_config, load_from_config
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_tpu.ops import gsplat_pallas

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "rgca_synthetic.yml")
# max_pairs_per_tile: the config's 128 overflows some tiles, and the Pallas
# backward in interpret mode leaves the pair-gradient blocks it never visits
# unwritten (NaN), which its prefix sums spread to every parameter gradient;
# the port zero-fills them. 1024 holds every tile, so both sides are finite.
_OVERRIDES = ["model.render.use_pallas=true", "model.encoder.noise_std=0",
              "model.render.max_pairs_per_tile=1024"]
CPU = torch.device("cpu")


def _batch(ds):
    """Two samples: the identity camera and another one."""
    samples = [ds[0], ds[7]]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if not isinstance(samples[0][k], str)}


@pytest.fixture(scope="module")
def jax_step():
    """One train=True forward, the losses and the parameter gradients of
    the JAX package (module scope: tracing the interpreted Pallas kernels
    through value_and_grad is the slow part)."""
    gsplat_pallas.INTERPRET = True
    try:
        cfg = load_config(_CFG, overrides=_OVERRIDES)
        kw = dict(cfg.data)
        kw.pop("synthetic")
        ds = JSyntheticDataset(**kw)
        batch = _batch(ds)
        model = load_from_config(cfg.model, assets=ds.static_assets)
        loss_fn = load_from_config(cfg.loss, assets=ds.static_assets)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = model.init(jax.random.PRNGKey(0), jb)

        def loss_inner(p):
            preds = model.apply(p, jb, train=True,
                                rngs={"noise": jax.random.PRNGKey(3)})
            total, ldict = loss_fn(preds, jb, 0)
            return total, (ldict, preds)

        (total, (ldict, preds)), grads = jax.jit(jax.value_and_grad(
            loss_inner, has_aux=True))(params)
        out = dict(
            batch=batch, params=jax.device_get(params),
            total=float(total),
            ldict={k: float(v) for k, v in ldict.items()},
            grads=jax.device_get(grads),
            preds={k: np.asarray(v) for k, v in preds.items()},
        )
    finally:
        gsplat_pallas.INTERPRET = False
    # the backlit direction the run drew: cos_weight = spec_nml @ light_dir
    out["light_dir"] = np.stack([
        np.linalg.lstsq(out["preds"]["spec_nml"][b].astype(np.float64),
                        out["preds"]["cos_weight"][b, :, 0].astype(np.float64),
                        rcond=None)[0]
        for b in range(2)])[:, None].astype(np.float32)
    return out


def _torch_model(extra=(), generator=None):
    cfg = t_load_config(_CFG, overrides=_OVERRIDES + list(extra))
    kw = dict(cfg.data)
    kw.pop("synthetic")
    ds = SyntheticDataset(**kw)
    model = t_load_from_config(cfg.model, assets=ds.static_assets,
                               device="cpu", generator=generator)
    loss_fn = t_load_from_config(cfg.loss, assets=ds.static_assets)
    return cfg, model, loss_fn


def test_train_step_losses_and_gradients_match_jax(jax_step):
    cfg, model, loss_fn = _torch_model()
    state = params_from_jax(jax_step["params"])
    # the training modules' parameters are carried across by name
    assert {"cal.cal_params", "learn_blur.weights_raw"} <= set(state)
    model.module.load_state_dict(state, strict=True)
    tb = to_device(jax_step["batch"], CPU)
    tb["light_dir"] = torch.from_numpy(jax_step["light_dir"])
    preds = model.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, 0)
    total.backward()

    assert set(ldict) == set(jax_step["ldict"])
    np.testing.assert_allclose(total.item(), jax_step["total"], rtol=1e-4)
    for k, ref in jax_step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for k in ("rgb", "alpha", "embs", "learn_blur_weights"):
        np.testing.assert_allclose(
            preds[k].detach().numpy(), jax_step["preds"][k], rtol=1e-4,
            atol=1e-4, err_msg=k)

    ref_grads = params_from_jax(jax_step["grads"])
    named = dict(model.module.named_parameters())
    assert set(named) == set(ref_grads)
    nonzero = 0
    for name, p in named.items():
        r = ref_grads[name].numpy()
        assert p.grad is not None and p.grad.shape == r.shape, name
        assert np.isfinite(r).all(), name
        scale = float(np.abs(r).max())
        nonzero += scale > 0
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)
    # all five top-level modules take a gradient (the batch has a
    # non-identity camera, so the calibration does too)
    assert nonzero >= len(named) - 2
    for top in ("encoder", "geomdecoder", "decoder", "cal", "learn_blur"):
        assert any(float(p.grad.abs().max()) > 0
                   for n, p in named.items() if n.startswith(top + ".")), top


def test_backlit_branch_matches_jax(jax_step):
    """``color_rand`` and ``cos_weight`` for the direction the JAX run drew;
    and, with one unit light, the branch repeats the diffuse term."""
    _cfg, model, _ = _torch_model()
    model.module.load_state_dict(params_from_jax(jax_step["params"]),
                                 strict=True)
    tb = to_device(jax_step["batch"], CPU)
    tb["light_dir"] = torch.from_numpy(jax_step["light_dir"])
    with torch.no_grad():
        preds = model.apply(tb, train=True)
    for k in ("cos_weight", "color_rand"):
        assert tuple(preds[k].shape) == jax_step["preds"][k].shape
        # atol 5e-5: the direction is recovered by least squares
        np.testing.assert_allclose(preds[k].numpy(), jax_step["preds"][k],
                                   rtol=1e-4, atol=5e-5, err_msg=k)
    assert float(preds["color_rand"].max()) > 0
    np.testing.assert_allclose(
        preds["cos_weight"].numpy(),
        (tb["light_dir"] * preds["spec_nml"]).sum(-1, keepdim=True).numpy(),
        rtol=1e-5, atol=1e-6)
    with torch.no_grad():   # the branch is training-only
        assert "color_rand" not in model.apply(tb, train=False)

    # one light of intensity 1 along the head-relative direction d: the
    # light's SH is the branch's, so albedo * color_rand = clip(diff_color)
    d = np.asarray([[[0.3, -0.5, 0.8]], [[-0.6, 0.2, 0.7]]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    one = dict(tb)
    head_R = tb["head_pose"][:, :3, :3]
    one["light_pos"] = torch.zeros_like(tb["light_pos"])
    # head-relative = (p - t) @ R  =>  p = d @ R^T + t
    one["light_pos"][:, :1] = 500.0 * torch.einsum(
        "blk,bjk->blj", torch.from_numpy(d), head_R) \
        + tb["head_pose"][:, None, :3, 3]
    one["n_lights"] = torch.ones_like(tb["n_lights"])
    one["light_intensity"] = torch.ones_like(tb["light_intensity"])
    one["light_dir"] = torch.from_numpy(d)
    with torch.no_grad():
        p1 = model.apply(one, train=True)
    albedo = model.module.decoder.albedo.detach()
    np.testing.assert_allclose(
        (albedo * p1["color_rand"]).numpy(),
        p1["diff_color"].clamp(min=0.0).numpy(), rtol=1e-4, atol=1e-5)


def test_training_draws_come_from_the_generator():
    """noise_std=1: the noise has the encoder's shape and unit scale, the
    same generator seed gives the same step twice, another seed another."""
    extra = ["model.encoder.noise_std=1.0"]

    def run(seed):
        cfg, model, loss_fn = _torch_model(
            extra, torch.Generator().manual_seed(seed))
        opt_cfg = dict(cfg.optimizer)
        opt_cfg.setdefault("lr", cfg.lr)
        optimizer = build_optimizer(opt_cfg, model.module)
        kw = dict(cfg.data)
        kw.pop("synthetic")
        tb = to_device(_batch(SyntheticDataset(**kw)), CPU)
        with torch.no_grad():
            preds = model.apply(tb, train=True)
        step = t_train.make_train_step(model, loss_fn, optimizer)
        total, ldict = step(tb, 0)
        return model, preds, float(total), tb

    m_a, p_a, total_a, tb = run(5)
    m_b, p_b, total_b, _ = run(5)
    m_c, p_c, total_c, _ = run(6)
    assert total_a == total_b and total_a != total_c
    for (n, a), (_, b) in zip(m_a.module.named_parameters(),
                              m_b.module.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(p_a["embs"], p_b["embs"])
    assert not torch.equal(p_a["embs"], p_c["embs"])

    noise = (p_a["embs"] - p_a["embs_mu"]) / torch.exp(p_a["embs_logvar"])
    assert noise.shape == (2, m_a.module.n_embs)
    assert 0.5 < float(noise.std()) < 1.6 and abs(float(noise.mean())) < 0.6
    # a given noise is used as it is
    given = torch.full((2, m_a.module.n_embs), 0.25)
    with torch.no_grad():
        p = m_a.apply({**tb, "noise": given}, train=True)
    torch.testing.assert_close(
        p["embs"], p["embs_mu"] + torch.exp(p["embs_logvar"]) * given)
    with torch.no_grad():   # no draw at eval
        p = m_a.apply(tb, train=False)
    assert torch.equal(p["embs"], p["embs_mu"])


def test_decoder_recomputation_keeps_the_gradients():
    """remat_decoder recomputes the prim decoder in the backward (the draws
    are made outside the recomputed call): same loss, same gradients."""
    grads = {}
    for remat in (True, False):
        cfg, model, loss_fn = _torch_model(
            ["model.encoder.noise_std=1.0",
             f"model.remat_decoder={str(remat).lower()}"],
            torch.Generator().manual_seed(1))
        assert model.module.remat_decoder is remat
        kw = dict(cfg.data)
        kw.pop("synthetic")
        tb = to_device(_batch(SyntheticDataset(**kw)), CPU)
        total, _ = loss_fn(model.apply(tb, train=True), tb, 0)
        total.backward()
        grads[remat] = (total.item(), {
            n: p.grad.clone() for n, p in model.module.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for n, g in grads[True][1].items():
        torch.testing.assert_close(g, grads[False][1][n], rtol=1e-5,
                                   atol=1e-7, msg=lambda m: f"{n}: {m}")


def test_norms_have_finite_gradients_at_zero_vectors():
    """Every normalisation on the training path at a zero vector: the
    model's ``_normalize`` (quaternions, normals, view and light
    directions), the spherical-Gaussian ``_unit`` and ``vert_normals`` on a
    degenerate face."""
    for fn in (t_rgca._normalize, t_sg._unit):
        v = torch.zeros(2, 3, requires_grad=True)
        out = fn(v)
        out.sum().backward()
        assert torch.isfinite(out).all() and torch.isfinite(v.grad).all(), fn
    v = torch.zeros(1, 4, 3, requires_grad=True)   # all vertices coincide
    vi = torch.tensor([[0, 1, 2], [1, 2, 3]])
    out = t_geom.vert_normals(v, vi)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(v.grad).all()
