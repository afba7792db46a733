"""Parity of the port's batch-folded render (``GOLIATH_GSPLAT_FOLD=1``: one
binning over the B images stacked in tile space, K6's plain versions, one
reduce) with the JAX package's fold on the CPU, the Pallas kernels in
interpret mode. The fold is held against the JAX fold, not against the
port's per-sample path: its depth keys have fewer bits (from the global tile
count) and its pair budget is global.

Tolerances: outputs atol 1e-4 / rtol 1e-4 (float32 on both sides, the same
sums in other orders: the plain compositor takes a cumprod where the Pallas
kernel takes exp of a log-space prefix matmul). Gradients rtol 1e-3 with
atol 1e-3 of each gradient's largest entry (per-prim sums are differences
of float32 prefixes over the whole global budget on both sides, in other
orders). The training step: losses rtol 1e-4, parameter gradients as
``tests/test_torch_rgca_train.py`` holds them (rtol 1e-3, atol 1e-3 of the
parameter's largest gradient).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda
from goliath_torch.test import to_device
from goliath_tpu.config import load_config, load_from_config
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_tpu.ops import gsplat as jg
from goliath_tpu.ops import gsplat_pallas

from test_torch_rgca_train import _CFG, _OVERRIDES, _batch, _torch_model

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

H, W = 64, 32
KW = dict(tile_size=16, max_pairs_per_tile=256, chunk=32, pallas_inner=16,
          pair_budget_mult=8, use_pallas=True)


def _scene(shift_sample0=0.0):
    """tests/test_gsplat_fold.py's scene: B = 3, N = 220, 64x32."""
    rs = np.random.RandomState(7)
    B, N = 3, 220
    K = np.asarray([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * B,
                   np.float32)
    Rt = np.asarray([np.eye(4)[:3]] * B, np.float32)
    pos = rs.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(3.0, 9.0, (B, N))
    quat = rs.standard_normal((B, N, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    scale = np.exp(rs.standard_normal((B, N, 3)) * 0.3).astype(
        np.float32) * 0.05
    op = rs.uniform(0.2, 0.9, (B, N, 1)).astype(np.float32)
    col = rs.uniform(0, 1, (B, N, 3)).astype(np.float32)
    pos[0, :, 1] += shift_sample0
    return K, Rt, pos, quat, scale, op, col


@pytest.fixture
def fold_env(monkeypatch):
    monkeypatch.setenv("GOLIATH_GSPLAT_FOLD", "1")
    monkeypatch.setattr(gsplat_pallas, "INTERPRET", True)


def _spy_fold(monkeypatch):
    """Record the tile bounds and image count of every rasterize_tiled."""
    seen, orig = [], gsplat_cuda.rasterize_tiled

    def spy(*a, **kw):
        seen.append((a[6], a[7], kw.get("n_imgs", 1)))
        return orig(*a, **kw)

    monkeypatch.setattr(gsplat_cuda, "rasterize_tiled", spy)
    return seen


def _close(got, ref, name, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=name)


def test_fold_render_and_gradients_match_jax_fold(fold_env, monkeypatch):
    """Outputs and the gradients for pos, quat, scale, opacity and colour of
    a scalar of all four outputs; one folded compositor call for the
    batch."""
    K, Rt, *prims = _scene()
    rng = np.random.RandomState(1)
    w_rgb = rng.rand(3, 3, H, W).astype(np.float32)
    w_a = rng.rand(3, 1, H, W).astype(np.float32)
    w_d = rng.rand(3, 1, H, W).astype(np.float32) * 0.1

    def j_loss(*p):
        o = jg.render(W, H, jnp.asarray(K), jnp.asarray(Rt), *p, **KW)
        return ((o["render"] * w_rgb).sum() + (o["alpha"] * w_a).sum()
                + (o["depth"] * w_d).sum()), o

    (ref_val, ref_out), ref = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *map(jnp.asarray, prims))
    seen = _spy_fold(monkeypatch)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in prims]
    o = tg.render(W, H, torch.from_numpy(K), torch.from_numpy(Rt), *tp, **KW)
    assert len(seen) == 1 and seen[0][2] == 3
    assert seen[0][0].shape == (3 * 4 * 2,)          # ntx x (B * nty) tiles
    val = ((o["render"] * torch.from_numpy(w_rgb)).sum()
           + (o["alpha"] * torch.from_numpy(w_a)).sum()
           + (o["depth"] * torch.from_numpy(w_d)).sum())
    val.backward()
    assert set(o) == set(ref_out) - {"radii"}
    for k in o:
        assert tuple(o[k].shape) == ref_out[k].shape, k
        _close(o[k], ref_out[k], k)
    assert float(o["alpha"].detach().max()) > 0.5
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-4)
    for name, t, r in zip(("pos", "quat", "scale", "opacity", "colour"),
                          tp, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all() and np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)


def test_fold_render_with_overflowing_tiles_matches_jax(fold_env,
                                                        monkeypatch):
    """Forward only: tiles over max_pairs_per_tile (the JAX interpret
    backward leaves the blocks it never visits NaN)."""
    K, Rt, *prims = _scene()
    kw = dict(KW, max_pairs_per_tile=32, chunk=16, pallas_inner=8)
    ref = jax.jit(lambda *p: jg.render(W, H, *p, **kw))(
        *map(jnp.asarray, (K, Rt, *prims)))
    seen = _spy_fold(monkeypatch)
    got = tg.render(W, H, *map(torch.from_numpy, (K, Rt, *prims)), **kw)
    start, end, n_imgs = seen[0]
    assert n_imgs == 3 and int((end - start).max()) > 32
    for k in got:
        _close(got[k], ref[k], k)


def test_fold_prims_stay_in_their_image(fold_env, monkeypatch):
    """Sample 0's prims pushed far below its image must not leak pairs into
    sample 1's tile rows (each sample's box is clipped before it moves):
    sample 0 renders empty, and the port equals the JAX fold."""
    K, Rt, *prims = _scene(shift_sample0=1e3)
    ref = jax.jit(lambda *p: jg.render(W, H, *p, **KW))(
        *map(jnp.asarray, (K, Rt, *prims)))
    got = tg.render(W, H, *map(torch.from_numpy, (K, Rt, *prims)), **KW)
    assert float(got["render"][0].abs().max()) == 0.0
    assert float(got["render"][1:].abs().max()) > 0.1
    for k in got:
        _close(got[k], ref[k], k)
    # samples 1 and 2 as the per-sample path renders them (this scene's
    # depths and budget leave the fold's coarser keys nothing to reorder)
    monkeypatch.setenv("GOLIATH_GSPLAT_FOLD", "0")
    per = tg.render(W, H, *map(torch.from_numpy, (K, Rt, *prims)), **KW)
    _close(got["render"], per["render"].numpy(), "render")


@pytest.fixture(scope="module")
def jax_fold_step():
    """One train=True forward, losses and parameter gradients of the JAX
    package under the fold, at configs/rgca_synthetic.yml with
    max_pairs_per_tile 1024 (as tests/test_torch_rgca_train.py, whose
    helpers build the batch and the port's model)."""
    before = os.environ.get("GOLIATH_GSPLAT_FOLD")
    os.environ["GOLIATH_GSPLAT_FOLD"] = "1"
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
        out = dict(batch=batch, params=jax.device_get(params),
                   total=float(total),
                   ldict={k: float(v) for k, v in ldict.items()},
                   grads=jax.device_get(grads),
                   preds={k: np.asarray(v) for k, v in preds.items()})
    finally:
        gsplat_pallas.INTERPRET = False
        if before is None:
            del os.environ["GOLIATH_GSPLAT_FOLD"]
        else:
            os.environ["GOLIATH_GSPLAT_FOLD"] = before
    # the backlit direction the run drew: cos_weight = spec_nml @ light_dir
    out["light_dir"] = np.stack([
        np.linalg.lstsq(out["preds"]["spec_nml"][b].astype(np.float64),
                        out["preds"]["cos_weight"][b, :, 0].astype(np.float64),
                        rcond=None)[0]
        for b in range(2)])[:, None].astype(np.float32)
    return out


def test_fold_train_step_matches_jax(jax_fold_step, monkeypatch):
    monkeypatch.setenv("GOLIATH_GSPLAT_FOLD", "1")
    seen = _spy_fold(monkeypatch)
    _cfg, model, loss_fn = _torch_model()
    model.module.load_state_dict(params_from_jax(jax_fold_step["params"]),
                                 strict=True)
    tb = to_device(jax_fold_step["batch"], torch.device("cpu"))
    tb["light_dir"] = torch.from_numpy(jax_fold_step["light_dir"])
    total, ldict = loss_fn(model.apply(tb, train=True), tb, 0)
    total.backward()
    assert [s[2] for s in seen] == [2]              # one folded render
    np.testing.assert_allclose(total.item(), jax_fold_step["total"],
                               rtol=1e-4)
    assert set(ldict) == set(jax_fold_step["ldict"])
    for k, ref in jax_fold_step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    ref_grads = params_from_jax(jax_fold_step["grads"])
    named = dict(model.module.named_parameters())
    assert set(named) == set(ref_grads)
    for name, p in named.items():
        r = ref_grads[name].numpy()
        assert np.isfinite(r).all(), name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)
    for top in ("encoder", "geomdecoder", "decoder"):
        assert any(float(p.grad.abs().max()) > 0
                   for n, p in named.items() if n.startswith(top + ".")), top
