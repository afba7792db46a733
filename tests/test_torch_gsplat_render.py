"""Part of tests/test_torch_gsplat.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_tpu.ops import gsplat as jg, gsplat_pallas

from tests.test_torch_gsplat import _close, _scene

torch.set_num_threads(1)


@pytest.mark.parametrize("return_depth", [True, False])
def test_render_matches_jax_pallas_path(monkeypatch, return_depth):
    """The whole forward render, batch 2, against JAX render(use_pallas=True)
    with the Pallas kernels interpreted. Inputs keep every tile under
    max_pairs_per_tile."""
    monkeypatch.setattr(gsplat_pallas, "INTERPRET", True)
    rng = np.random.RandomState(4)
    H, W = 48, 64
    scene = _scene(rng, 2, 80, H, W)
    kw = dict(return_depth=return_depth, tile_size=16,
              max_pairs_per_tile=256, chunk=32, pallas_inner=16,
              pair_budget_mult=4)
    ref = jax.jit(lambda *a: jg.render(W, H, *a, use_pallas=True, **kw))(
        *map(jnp.asarray, scene))
    got = tg.render(W, H, *map(torch.from_numpy, scene), use_pallas=True,
                    **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        _close(got[k], ref[k], k)
    assert float(got["alpha"].max()) > 0.5  # something was rendered


def test_render_raises_on_unported_branches(monkeypatch):
    """Both branches raised until they were ported. The tile-sharded
    branch now routes ``render(..., tile_shard_mesh=, tile_shard_axis=)``
    to ``parallel.tile_shard.render_tile_sharded`` with the render's
    arguments, also under GOLIATH_GSPLAT_FOLD=1 (the band path never
    folds), and refuses ``return_radii`` as the JAX package's assert does
    (tests/test_torch_parallel_tile.py holds the band render against the
    JAX one). The batch-folded branch (K6) runs where the JAX package
    takes it: use_pallas, GOLIATH_GSPLAT_FOLD=1, B > 1, no radii
    (tests/test_torch_gsplat_fold.py holds it against the JAX fold)."""
    from goliath_torch.parallel import tile_shard
    from goliath_torch.parallel.sharding import Mesh

    scene = [torch.from_numpy(a) for a in _scene(
        np.random.RandomState(5), 2, 8, 16, 16)]
    mesh = Mesh(["cpu"] * 2, ("x",))
    banded, routed = tile_shard.render_tile_sharded, []

    def band_spy(*a, **kw):
        routed.append((a[:4], kw))
        return banded(*a, **kw)

    monkeypatch.setattr(tile_shard, "render_tile_sharded", band_spy)
    with pytest.raises(ValueError, match="return_radii"):
        tg.render(16, 16, *scene, tile_shard_mesh=mesh, tile_shard_axis="x",
                  return_radii=True)
    assert not routed
    monkeypatch.setenv("GOLIATH_GSPLAT_FOLD", "1")
    out = tg.render(16, 16, *scene, tile_shard_mesh=mesh,
                    tile_shard_axis="x", use_pallas=True, chunk=32)
    ref = tg.render(16, 16, *scene, use_pallas=False, chunk=32)
    assert len(routed) == 1 and routed[0][0] == (mesh, "x", 16, 16)
    assert routed[0][1]["use_pallas"] and routed[0][1]["chunk"] == 32
    assert set(out) == set(ref) - {"radii"}
    for k in out:
        assert out[k].shape == ref[k].shape, k
    fold, calls = tg._render_folded, []

    def spy(*a):
        calls.append(a)
        return fold(*a)

    monkeypatch.setattr(tg, "_render_folded", spy)
    out = tg.render(16, 16, *scene, use_pallas=True)
    assert len(calls) == 1 and out["render"].shape == (2, 3, 16, 16)
    tg.render(16, 16, *scene)                       # XLA window: no fold
    tg.render(16, 16, *scene, use_pallas=True, return_radii=True)
    tg.render(16, 16, *[t[:1] for t in scene], use_pallas=True)   # B = 1
    assert len(calls) == 1


def test_compositor_backward_raises_until_k2():
    """The backward raised until K2 was ported; now it runs (K2's plain
    version on the CPU) and gives finite, non-zero color gradients
    (tests/test_torch_gsplat_bwd.py holds them against the JAX package)."""
    rng = np.random.RandomState(6)
    scene = [torch.from_numpy(a) for a in _scene(rng, 1, 20, 16, 16)]
    scene[6].requires_grad_(True)
    out = tg.render(16, 16, *scene, max_pairs_per_tile=64, chunk=16)
    out["render"].sum().backward()
    grad = scene[6].grad
    assert grad.shape == scene[6].shape
    assert bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)
