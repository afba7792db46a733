"""Parity of the mesh_vae path's building blocks with the JAX package on the
CPU: the weight-normalized tied-bias conv, the residual blocks, the UNet,
the shadow nets, bilinear resizing, the host-side blur, UV impainting, view
cosines, the depth-discontinuity mask, linear blend skinning, the seam
sampler and the synthetic body-model assets. Flax parameters are carried
across by goliath_torch.convert.params_from_jax.

Tolerances: integer and host-side numpy tables exactly; float32 network
and resize outputs at atol 1e-5 / rtol 1e-5 of the same products summed in
another order (atol 1e-4 where values reach ~1e2); skinning at atol 1e-4 on
positions ~1e2 (3x3 inverses by LAPACK on both sides, in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.data import synthetic as tsyn
from goliath_torch.utils import lbs as tlbs
from goliath_torch.utils import seams as tseams
from goliath_tpu.data import synthetic as jsyn
from goliath_tpu.utils import lbs as jlbs
from goliath_tpu.utils import seams as jseams

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _module_outputs(jmod, tmod, *xs):
    """Init the flax module, carry its parameters to the torch module and
    run both on the same inputs; returns (torch out, jax out)."""
    jx = [jnp.asarray(x) for x in xs]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), *jx)
    ref = jax.jit(jmod.apply)(params, *jx)
    tmod.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x) for x in xs])
    return got, ref


def _lbs_case():
    v, vi, vt, vti = jsyn.make_sphere_mesh(6, 8)
    model, cfg = jsyn.make_synthetic_lbs(v, vi, vt, vti, 4)
    rng = np.random.RandomState(7)
    pose = (0.3 * rng.randn(2, 6 + 3 * 3)).astype(np.float32)
    scale = (0.1 * rng.randn(2, 4)).astype(np.float32)
    return v, model, cfg, pose, scale, rng


def test_skeleton_solve_and_skinning_match_jax():
    v, model, cfg, pose, scale, rng = _lbs_case()
    jl_ = jlbs.LinearBlendSkinning(model, cfg)
    tl_ = tlbs.LinearBlendSkinning(model, cfg, device="cpu")
    np.testing.assert_array_equal(tl_.skin_indices_np, jl_.skin_indices)
    np.testing.assert_array_equal(tl_.skin_weights_np, jl_.skin_weights)
    _close(tl_.bind_state_np, jl_.bind_state)
    tp, ts = torch.from_numpy(pose), torch.from_numpy(scale)
    jp, js = jnp.asarray(pose), jnp.asarray(scale)
    _close(tl_.param_transform(torch.cat([tp, ts], 1)),
           jl_.param_transform(jnp.concatenate([jp, js], 1)))
    states_t = tl_._solve(tp, ts)
    states_j = jax.jit(jl_._solve)(jp, js)
    _close(states_t, states_j)
    _close(tlbs.states_to_matrix(tl_.bind_state, states_t),
           jax.jit(jlbs.states_to_matrix)(jnp.asarray(jl_.bind_state),
                                           states_j))
    verts = (v[None] + rng.randn(2, *v.shape)).astype(np.float32)
    posed_t = tl_(tp, ts, torch.from_numpy(verts))
    posed_j = jax.jit(jl_.__call__)(jp, js, jnp.asarray(verts))
    _close(posed_t, posed_j, atol=1e-4)
    _close(tl_.unpose(tp, ts, posed_t), jax.jit(jl_.unpose)(jp, js, posed_j),
           atol=1e-4)
    _close(tl_.unpose(tp, ts, posed_t), verts, atol=1e-3)  # round trip


def test_lbs_module_matches_jax():
    v, model, cfg, pose, _scale, rng = _lbs_case()
    skel = np.zeros((1, 4), np.float32)
    gs = np.asarray([1.0, 1.1, 0.9], np.float32)
    jm = jlbs.LBSModule(model, cfg, v[None], skel, gs)
    tm = tlbs.LBSModule(model, cfg, v[None], skel, gs, device="cpu")
    delta = (rng.randn(2, *v.shape) * 0.5).astype(np.float32)
    tp, jp = torch.from_numpy(pose), jnp.asarray(pose)
    posed_t = tm.pose(torch.from_numpy(delta), tp)
    _close(posed_t, jax.jit(jm.pose)(jnp.asarray(delta), jp), atol=1e-4)
    _close(tm.unpose(posed_t, tp),
           jax.jit(jm.unpose)(jnp.asarray(posed_t.numpy()), jp), atol=1e-4)


def _seam_data(rng, n):
    """Seam data of n x n texels: random copies (with a repeated dst, which
    keeps its last copy) and a weighted resample of ~10% of the texels."""
    dst = rng.randint(0, n, (40, 2))
    dst[5] = dst[30]
    weights = np.zeros((1, 1, n, n), np.float32)
    band = rng.rand(n, n) < 0.1
    weights[0, 0][band] = rng.rand(int(band.sum())).astype(np.float32)
    return {"dst_ij": dst, "src_ij": rng.randint(0, n, (40, 2)),
            "uvs": rng.rand(n, n, 2).astype(np.float32),
            "weights": weights}


def test_seam_sampler_matches_jax():
    rng = np.random.RandomState(8)
    data = _seam_data(rng, 24)
    x = rng.randn(2, 3, 24, 24).astype(np.float32)
    js = jseams.SeamSampler(data)
    ts = tseams.SeamSampler(data, device="cpu")
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(ts.impaint(tx), jax.jit(js.impaint)(jx))
    _close(ts.resample(tx), jax.jit(js.resample)(jx))
    _close(ts(tx), jax.jit(js.__call__)(jx))
    # the dense oracles of the JAX package (reference semantics)
    _close(ts.impaint(tx), jseams.impaint_batch(
        jx, jnp.asarray(data["dst_ij"]), jnp.asarray(data["src_ij"])))
    _close(ts.resample(tx), jseams.resample_tex(
        jx, jnp.asarray(data["uvs"]), jnp.asarray(data["weights"][0])),
        atol=1e-5)
    # the backward is autograd's: the JAX package's hand-written transpose
    tx.requires_grad_(True)
    g = rng.randn(*x.shape).astype(np.float32)
    (ts(tx) * torch.from_numpy(g)).sum().backward()
    ref = jax.jit(jax.grad(lambda a: (js(a) * jnp.asarray(g)).sum()))(jx)
    _close(tx.grad, ref)


def test_synthetic_body_assets_match_jax():
    kw = dict(n_cams=2, n_frames=2, img_h=24, img_w=20, uv_size=16,
              n_lat=5, n_lon=7, seed=3)
    t, j = tsyn.SyntheticDataset(**kw), jsyn.SyntheticDataset(**kw)
    ta, ja = t.static_assets, j.static_assets
    assert set(ta) == set(ja)
    for k in ("template_mesh_unscaled", "skeleton_scales", "ao_mean",
              "floor_Rt"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert ta.lbs_model_json == ja.lbs_model_json
    for k, v in ja.lbs_config_dict.items():
        np.testing.assert_array_equal(np.asarray(ta.lbs_config_dict[k]),
                                      np.asarray(v), err_msg=k)
    for idx in (0, 3):
        for k, v in j[idx].items():
            np.testing.assert_array_equal(np.asarray(t[idx][k]),
                                          np.asarray(v), err_msg=k)
