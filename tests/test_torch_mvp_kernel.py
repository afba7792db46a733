"""K8's plain version (goliath_torch/ops/mvp_cuda.py ``mvp_march``, which
runs ``mvp_march_plain`` on CPU tensors) on the per-tile inputs the kernel
takes (ops/mvp.py ``march_inputs``): ``hold_kernel_route``, which
tests/test_torch_mvp_tiled.py (MARCH_CASES: a window cut, more than R hits,
a budget overflow and a full tile list) and tests/test_torch_mvp_warp.py (a
warp field) apply to the march they hold against the JAX package's jitted
``mvp_raymarch_tiled``: its rgba equal to that march's, and its in-group
counts (rays over R, step-capped rays, window-cut pairs and prims,
deposited taps) equal to those taken from the JAX package's own binning and
arithmetic (``jax_march_counts``). The tests here: the march and the shadow
integral on CPU tensors never load the kernels' extension, and on the
card's route neither falls back to its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat_cuda as gc
from goliath_torch.ops import mvp as tm
from goliath_torch.ops import mvp_cuda as mc
from goliath_tpu.ops import binning as jb
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import T, _rays, _scene

torch.set_num_threads(1)


def kernel_route(scene, rays, stepsize, warp=None, **kw):
    """The port's march through K8's wrapper on CPU tensors (its plain
    version): (rgba [4, H, W], the counts as ints)."""
    rp, rd, tminmax, K_cam, Rt = rays
    inp, _, _ = tm.march_inputs(
        T(rp), T(rd), stepsize, T(tminmax), *(T(a) for a in scene),
        T(K_cam), T(Rt), warp=None if warp is None else T(warp), **kw)
    out, counts = mc.mvp_march(inp, True)
    return tm.untile(inp, out).numpy(), {k: int(v) for k, v in counts.items()}


def jax_march_counts(scene, rays, stepsize, kw):
    """The march's in-group counts from the JAX package's own binning (its
    tile rects and ``bin_to_tiles``, goliath_tpu/ops/mvp.py:404-432) and
    spans (``_ray_box_span_g``), then its march group's expressions
    (:482-646) in float32 numpy over every tile at once: rays over R,
    step-capped rays (t0 + (S - 1) stepsize + 1e-5 < t_exit), window-cut
    pairs and prims, and the taps its mask lets through."""
    rp, rd, tminmax, K_cam, Rt = rays
    H, W = rp.shape[:2]
    ts = kw.get("tile_size", 16)
    ntx, nty = -(-W // ts), -(-H // ts)
    K = scene[0].shape[0]
    S = kw["max_steps"]
    Sp = min(kw.get("window_steps") or S, S)
    M = kw["max_prims_per_tile"]
    R = min(kw.get("max_prims_per_ray", 16), M)

    @jax.jit
    def binned(primpos, primrot, primscale, rp, rd, tminmax, K_cam, Rt):
        pmin, pmax = jm.prim_world_aabb(primpos, primrot, primscale)
        corners = jnp.stack([jnp.stack([
            jnp.where(cx, pmax[:, 0], pmin[:, 0]),
            jnp.where(cy, pmax[:, 1], pmin[:, 1]),
            jnp.where(cz, pmax[:, 2], pmin[:, 2])], -1)
            for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)], 1)
        cam = jnp.einsum("ij,knj->kni", Rt[:3, :3], corners) + Rt[:3, 3]
        z = jnp.clip(cam[..., 2], min=1e-4)
        pix = jnp.einsum("ij,knj->kni", K_cam[:2, :2],
                         cam[..., :2] / z[..., None]) + K_cam[:2, 2]
        behind = jnp.any(cam[..., 2] <= 1e-4, axis=1)
        xy_min = jnp.where(behind[:, None], 0.0, jnp.min(pix, axis=1))
        xy_max = jnp.where(behind[:, None],
                           jnp.asarray([[W, H]], jnp.float32),
                           jnp.max(pix, axis=1))
        b = jb.bin_to_tiles(
            jnp.floor(xy_min / ts).astype(jnp.int32),
            (jnp.floor(xy_max / ts) + 1).astype(jnp.int32),
            jnp.ones((K,), bool), ntx, nty, kw.get("max_tiles_per_prim", 64),
            kw.get("pair_budget_mult", 8) * K)
        # every tile's first M listed prims at once, as the JAX group does
        idxs = b.tile_start[:, None] + jnp.arange(M, dtype=jnp.int32)
        pids = b.sorted_prim[jnp.clip(idxs, 0, b.sorted_prim.shape[0] - 1)]
        tiles = [jm._to_tiles(a, ntx, nty, ts) for a in (rp, rd, tminmax)]
        spans = jm._ray_box_span_g(tiles[0], tiles[1], pmin[pids],
                                   pmax[pids])                # [T, M, P]
        return idxs < b.tile_end[:, None], pids, tiles, spans

    pm, pids, (rp_t, rd_t, tm_t), (tmin_pk, tmax_pk) = jax.tree_util.tree_map(
        np.asarray, binned(*(jnp.asarray(a) for a in (*scene[:3], *rays))))
    primpos, primrot, primscale = scene[:3]
    inside = np.zeros((nty * ts, ntx * ts), bool)
    inside[:H, :W] = True
    ins = inside.reshape(nty, ts, ntx, ts).transpose(0, 2, 1, 3) \
        .reshape(ntx * nty, ts * ts)                               # [T, P]
    f32 = np.float32
    step = f32(stepsize)
    hit = (tmax_pk > tmin_pk) & pm[..., None]
    tm0, tm1 = tm_t[..., 0], tm_t[..., 1]
    t_enter = np.maximum(np.where(hit, tmin_pk, np.inf).min(1), tm0)
    t_exit = np.minimum(np.where(hit, tmax_pk, -np.inf).max(1), tm1)
    any_hit = np.isfinite(t_enter) & (t_exit > t_enter)
    t_enter = np.where(any_hit, t_enter, f32(0))
    t_exit = np.where(any_hit, t_exit, f32(-1))
    t0 = tm0 + np.floor(np.maximum(t_enter - tm0, f32(0)) / step) * step
    counts = {"rays_over_r": int(((hit.sum(1) > R) & ins).sum()),
              "rays_step_capped": int((any_hit & ins & (
                  t0 + f32((S - 1) * stepsize) + f32(1e-5) < t_exit)).sum())}
    key = np.where(hit, tmin_pk, np.inf)
    order = np.argsort(key, axis=1, kind="stable")[:, :R]          # [T, R, P]
    hit_r = np.isfinite(np.take_along_axis(key, order, 1))
    gp = np.take_along_axis(pids[..., None], order, 1)             # [T, R, P]
    rot, psc = primrot[gp], primscale[gp]
    Ac = np.einsum("tkpij,tpi->tkpj", rot, rd_t) * psc
    Bc = np.einsum("tkpij,tkpi->tkpj", rot,
                   rp_t[:, None] - primpos[gp]) * psc
    invA = f32(1) / np.where(np.abs(Ac) < f32(1e-12), f32(1e-12), Ac)
    t1, t2 = (f32(-1) - Bc) * invA, (f32(1) - Bc) * invA
    tmin_c = np.minimum(t1, t2).max(-1)
    tmax_c = np.maximum(t1, t2).min(-1)
    ok = (tmax_c > tmin_c) & hit_r
    s_lo = np.clip(np.nan_to_num(np.ceil((tmin_c - t0[:, None]) / step
                                         - f32(1e-5))), 0, S - 1)
    s_lo = s_lo.astype(np.int64)
    sidx = s_lo[..., None] + np.arange(Sp)
    tj = t0[:, None, :, None] + sidx.astype(f32) * step
    msk = ok[..., None] & (tj <= tmax_c[..., None] + f32(1e-5)) & (sidx < S)
    past = ok & (s_lo + Sp < S) & (
        t0[:, None] + (s_lo + Sp).astype(f32) * step
        <= tmax_c + f32(1e-5)) & ins[:, None]
    counts["taps"] = int(msk.sum())
    counts["window_cut_pairs"] = int(past.sum())
    cut = set(gp[past].tolist())
    counts["window_cut_prims"] = len(cut)
    return counts


def hold_kernel_route(got, scene, rays, stepsize, warp=None, drops=None,
                      **kw):
    """K8's plain version through ``march_inputs`` and its wrapper on the
    scene of a march whose image is ``got``: its rgba equal to ``got``
    (the same plain groups), its counts equal to ``jax_march_counts`` and,
    where the march counted ``drops``, its in-group counts equal to
    those."""
    img, counts = kernel_route(scene, rays, stepsize, warp, **kw)
    np.testing.assert_array_equal(img, got)
    assert counts == jax_march_counts(scene, rays, stepsize, kw)
    assert counts["taps"] > 0
    if drops is not None:
        for key in tm.MARCH_COUNTS[1:]:
            assert int(drops[key]) == counts[key], (key, counts)


def _refuse(*a, **kw):
    raise AssertionError("the kernels' extension was loaded")


def _march_args():
    scene, (rp, rd, tminmax, K_cam, Rt) = _scene(0), _rays(16, 16)
    return ([T(rp), T(rd), 0.05, T(tminmax), *(T(a) for a in scene),
             T(K_cam), T(Rt)], dict(max_steps=40, max_prims_per_tile=8,
                                    chunk=4))


def _shadow_args():
    g = torch.Generator().manual_seed(0)
    density = torch.rand(8, 8, 8, generator=g)
    pts = torch.rand(100, 3, generator=g) * 2 - 1
    return density, pts, torch.tensor([0.2, -0.1, -1.5])


def test_cpu_tensors_never_load_the_kernels(monkeypatch):
    """mvp_raymarch_tiled (with and without drops), mvp_march,
    shadow_at_points and shadow_integral on CPU tensors run their plain
    versions: the extension's loader, made to raise, is never called, and
    no launch is counted."""
    monkeypatch.setattr(gc, "load_kernels", _refuse)
    before = dict(gc.LAUNCHES)
    args, kw = _march_args()
    with torch.no_grad():
        out = tm.mvp_raymarch_tiled(*args, drops={}, **kw)
        assert torch.equal(out, tm.mvp_raymarch_tiled(*args, **kw))
        inp, _, _ = tm.march_inputs(*args, **kw)
        assert torch.equal(tm.untile(inp, mc.mvp_march(inp)[0]), out)
    density, pts, light = _shadow_args()
    got = tm.shadow_at_points(density, pts, light, 16)
    assert torch.equal(got, mc.shadow_integral(density, pts, light, 16))
    assert float(out[3].max()) > 0 and float(got.max()) > 0
    assert gc.LAUNCHES == before


def test_card_route_never_falls_back(monkeypatch):
    """With the tensors taken for the card's (ops/mvp.py's and
    ops/mvp_cuda.py's ``target_backend`` made to say cuda) and the loader
    made to raise: the march without gradient and with an integer fadeexp
    reaches the loader; with fadeexp 7.5 K8's wrapper raises ValueError;
    shadow_at_points reaches the loader under no_grad and raises ValueError
    with gradient on a density that needs one (K9 computes none). No
    route runs its plain version instead, and no launch is counted."""
    monkeypatch.setattr(gc, "load_kernels", _refuse)
    monkeypatch.setattr(tm, "target_backend", lambda t: "cuda")
    monkeypatch.setattr(mc, "target_backend", lambda t: "cuda")
    before = dict(gc.LAUNCHES)
    args, kw = _march_args()
    with torch.no_grad():
        with pytest.raises(AssertionError, match="extension was loaded"):
            tm.mvp_raymarch_tiled(*args, drops={}, **kw)
        with pytest.raises(ValueError, match="integer fadeexp"):
            tm.mvp_raymarch_tiled(*args, fadeexp=7.5, **kw)
    density, pts, light = _shadow_args()
    with torch.no_grad(), \
            pytest.raises(AssertionError, match="extension was loaded"):
        tm.shadow_at_points(density.requires_grad_(), pts, light, 16)
    with pytest.raises(ValueError, match="computes no gradient"):
        tm.shadow_at_points(density, pts, light, 16)
    with pytest.raises(ValueError, match="computes no gradient"):
        tm.shadow_at_points(density.detach(), pts.requires_grad_(), light,
                            16)
    assert gc.LAUNCHES == before
