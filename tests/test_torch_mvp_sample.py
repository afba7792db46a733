"""Part of tests/test_torch_mvp.py's tests, in a file of their own: a port test
file that runs long holds at most four tests, so that pytest-xdist's --dist
loadfile queues it after tests/test_tile_shard.py. The inputs, helpers and
tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_torch.utils.render_raymarcher import Raymarcher as TRaymarcher
from goliath_tpu.ops import mvp as jm
from goliath_tpu.utils.render_raymarcher import Raymarcher as JRaymarcher

from tests.test_torch_mvp import MARCH_OF_SCALE, RTOL, T, _rays, _scene, close

torch.set_num_threads(1)


@pytest.mark.parametrize("with_warp", [False, True])
def test_sample_prims_cf_matches_jax(with_warp):
    """Coordinates across and beyond the boxes (|y| up to 1.3: the zero
    padding, the validity mask and the packed rows' left-border corner)."""
    K, TD = 6, 4
    rng = np.random.RandomState(5)
    template = rng.rand(K, 4, TD, TD, TD).astype(np.float32)
    warp = None
    if with_warp:
        ax = np.linspace(-1, 1, TD, dtype=np.float32)
        zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
        warp = (np.stack([xx, yy, zz], 0)[None].repeat(K, 0)
                + 0.15 * rng.randn(K, 3, TD, TD, TD).astype(np.float32))
    ids = rng.randint(0, K, size=(K, 1, 1)).astype(np.int32)
    y = (rng.rand(3, K, 5, 7).astype(np.float32) - 0.5) * 2.6
    ref = jm.sample_prims_cf(jnp.asarray(template), jnp.asarray(ids),
                             *(jnp.asarray(c) for c in y), 8.0, 8.0,
                             warp=None if warp is None else jnp.asarray(warp))
    got = tm.sample_prims_cf(T(template), T(ids), *(T(c) for c in y), 8.0,
                             8.0, warp=None if warp is None else T(warp))
    assert got.shape == ref.shape == (4, K, 5, 7)
    close(got.numpy(), ref)
    # the channel-last twin on the same coordinates
    yl = np.moveaxis(y, 0, -1).reshape(K, -1, 3)
    ref_l = jm.sample_prims(jnp.asarray(template), jnp.asarray(ids[:, 0, 0]),
                            jnp.asarray(yl), 8.0, 8.0,
                            warp=None if warp is None else jnp.asarray(warp))
    got_l = tm.sample_prims(T(template), T(ids[:, 0, 0]), T(yl), 8.0, 8.0,
                            warp=None if warp is None else T(warp))
    close(got_l.numpy(), ref_l)


@pytest.mark.parametrize("B", [1, 2])
def test_raymarcher_matches_jax(B):
    """The facade at batch B (each sample its own scene and camera), with
    volradius 2 (positions and the culling camera normalized), valid_prims
    and window_overflow."""
    rp, rd, tminmax, K_cam, Rt = _rays(16, 16)
    scenes = [_scene(s, K=8) for s in range(B)]
    volradius = 2.0
    decout = {
        "primpos": np.stack([s[0] for s in scenes]) * volradius,
        "primrot": np.stack([s[1] for s in scenes]),
        "primscale": np.stack([s[2] for s in scenes]),
        "primrgba": np.stack([s[3] for s in scenes]),
        "valid_prims": np.arange(8) % 3 != 1,
    }
    rays = [np.repeat(a[None], B, 0) for a in (rp, rd, tminmax)]
    Rt_w = Rt.copy()
    Rt_w[:, 3] *= volradius
    cams = [np.repeat(a[None], B, 0) for a in (K_cam, Rt_w)]
    kw = dict(dt=0.2, max_steps=60, max_prims_per_tile=8, chunk=4,
              window_steps=10)
    jrm, trm = JRaymarcher(volradius, **kw), TRaymarcher(volradius, **kw)
    ref = jax.jit(lambda *a: jrm(*a)[:3])(
        *(jnp.asarray(a) for a in rays),
        {k: jnp.asarray(v) for k, v in decout.items()},
        *(jnp.asarray(a) for a in cams))
    got = trm(*(T(a) for a in rays), {k: T(v) for k, v in decout.items()},
              *(T(a) for a in cams))
    assert got[0].shape == (B, 3, 16, 16) and got[1].shape == (B, 1, 16, 16)
    assert float(ref[1].max()) > 0.3 and got[3] is None
    for g, r in zip(got[:3], ref):
        close(g.numpy(), r, MARCH_OF_SCALE)
    wo = float(trm.window_overflow({k: T(v) for k, v in decout.items()}))
    assert 0.0 < wo < 1.0
    assert wo == pytest.approx(float(jrm.window_overflow(
        {k: jnp.asarray(v) for k, v in decout.items()})), rel=RTOL)
    assert float(TRaymarcher(volradius, dt=0.2).window_overflow(
        {"primscale": T(decout["primscale"])})) == 0.0
