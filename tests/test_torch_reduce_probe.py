"""The row scan K7 and the presort reduce, and the compositor ablation probe
P1, on the CPU (their plain versions) against the JAX package, the Pallas
kernels in interpret mode.

Tolerances: the scans rtol 1e-5 / atol 1e-3, as the JAX package's own test
holds its kernel to numpy (float32 sums in other orders); the reduces
rtol 1e-4 / atol 1e-3 (differences of two float32 prefixes). P1's ``full``
variant walks the blocks K1 composited with K1's arithmetic and is held to
K1's plain version exactly; the other variants compute other things on
purpose and are held to what each computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda
from goliath_torch.scripts import probe_kernel, profile_reduce
from goliath_tpu.ops import gsplat as jg
from goliath_tpu.ops import gsplat_pallas

from test_torch_gsplat import _scene

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)


@pytest.mark.parametrize("f", [1, 3, 10, 16])
@pytest.mark.parametrize("m", [1, 63, 1000])
def test_cumsum_rows_plain_matches_pallas_kernel(m, f):
    """M ragged against the JAX kernel's block of 64 (one short block, one
    block less a row, 15 blocks and a part)."""
    x = np.random.RandomState(0).standard_normal((m, f)).astype(
        np.float32)
    ref = gsplat_pallas.cumsum_rows_pl(jnp.asarray(x), block=64,
                                       interpret=True)
    got = gsplat_cuda.cumsum_rows(torch.from_numpy(x))
    assert got.shape == (m, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    with pytest.raises(ValueError, match="float32"):
        gsplat_cuda.cumsum_rows(torch.zeros(3, f, dtype=torch.int32))


def test_reduce_presort_pair_grads_matches_jax_and_the_k3_route():
    """Random pre-sort pair grads, prims with 0..8 pairs and unused slots;
    then the sorted rows through the channel-first route (K3) give the same
    sums."""
    rng = np.random.RandomState(4)
    budget, F, N = 4096, 10, 300
    presort = rng.standard_normal((budget, F)).astype(np.float32)
    counts = rng.randint(0, 9, N).astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    offsets = (ends - counts).astype(np.int32)
    ref = jg.reduce_presort_pair_grads(*map(jnp.asarray, (
        presort, offsets, ends)))
    got = tg.reduce_presort_pair_grads(*map(torch.from_numpy, (
        presort, offsets, ends)))
    assert got.shape == (N, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)
    perm = torch.from_numpy(rng.permutation(budget).astype(np.int32))
    sorted_g = torch.from_numpy(presort)[perm.long()]
    cf = tg.reduce_sorted_pair_grads(sorted_g, perm, torch.from_numpy(offsets),
                                     torch.from_numpy(ends))
    np.testing.assert_allclose(cf.T.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_profile_reduce_permutations_agree():
    """profile_reduce's two permutation routes give the same pre-sort rows,
    and its presort reduce the channel-first one's sums (CPU, small N)."""
    sorted_g, perm, offsets, ends = profile_reduce.make_inputs(
        500, 2, 10, "cpu")
    a = profile_reduce.via_index_copy(sorted_g, perm)
    assert torch.equal(a, profile_reduce.via_gather(sorted_g, perm))
    assert torch.equal(a[perm.long()], sorted_g)
    got = tg.reduce_presort_pair_grads(a, offsets, ends)
    cf = tg.reduce_sorted_pair_grads(sorted_g, perm, offsets, ends)
    torch.testing.assert_close(got, cf.T, rtol=1e-4, atol=1e-4)


def _frame(opaque, maxpp, chunk):
    rng = np.random.RandomState(2)
    H, W, ts = 48, 64, 16
    arrays = [torch.from_numpy(a[0]) for a in _scene(rng, 1, 150, H, W,
                                                     opaque)]
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *arrays, H, W, ts, pair_budget=600)
    rows = gsplat_cuda.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                                      b.sorted_prim,
                                      (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=W // ts, nty=H // ts,
              chunk=chunk, max_pairs_per_tile=maxpp)
    return rows, b, kw


@pytest.mark.parametrize("opaque,maxpp,chunk", [
    (False, 256, 32),    # every tile whole
    (True, 64, 16),      # overflowing tiles and the T early-out
])
def test_probe_variants(opaque, maxpp, chunk):
    rows, b, kw = _frame(opaque, maxpp, chunk)
    img, T, cnt = gsplat_cuda.compositor_fwd(rows, b.tile_start, b.tile_end,
                                             **kw)
    out = {v: gsplat_cuda.probe_fwd(rows, b.tile_start, b.tile_end, cnt,
                                    variant=v, **kw)
           for v in gsplat_cuda.PROBE_VARIANTS}
    # full: K1's blocks and arithmetic, K1's result exactly
    assert torch.equal(out["full"][0], img) and torch.equal(out["full"][1], T)
    assert torch.equal(out["full"][2], cnt)
    for v, (v_img, v_T, v_cnt) in out.items():
        assert torch.equal(v_cnt, cnt), v              # the same blocks
        assert bool(torch.isfinite(v_img).all()), v
    # loadonly: the colour sum of each tile's walked rows, T untouched
    assert bool((out["loadonly"][1] == 1).all())
    assert float(out["loadonly"][0].max()) > float(img.max())
    # noexp and nochain composite other weights over the same rows
    for v in ("noexp", "nochain"):
        assert not torch.allclose(out[v][0], img, atol=1e-3), v
        assert float(out[v][1].min()) < 1.0, v
    if opaque:
        nchunks = maxpp // chunk + 1
        assert bool((cnt < nchunks).any())
    with pytest.raises(ValueError, match="variant"):
        gsplat_cuda.probe_fwd(rows, b.tile_start, b.tile_end, cnt,
                              variant="nomm", **kw)


def test_probe_kernel_scene_and_variants_run():
    """probe_kernel's scene builder and variant loop at a small size on the
    CPU (each variant's plain version), with a counting stand-in for the
    timer."""
    rows, start, end = probe_kernel.build_scene(n=2000, img_h=64, img_w=48,
                                                device="cpu")
    assert rows.shape == (8000, 12) and int((end - start).sum()) > 0
    calls = []
    times = probe_kernel.run_variants(
        rows, start, end, 64, 48, 16, 32, 64,
        lambda f: calls.append(f()) or float(len(calls)))
    assert list(times) == list(gsplat_cuda.PROBE_VARIANTS)
    assert len(calls) == 4 and all(torch.isfinite(c[0]).all() for c in calls)


def test_time_pair_grads_runs(monkeypatch):
    """time_pair_grads' loop over windows and chunks at a small size on the
    CPU (K1's and K2's plain versions), with host-clock stand-ins for the
    CUDA-event timers."""
    from goliath_torch.scripts import time_pair_grads
    from goliath_torch.utils import timing

    monkeypatch.setattr(timing, "cuda_call_ms", lambda fn: (fn(), 1.0))
    monkeypatch.setattr(timing, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    times = time_pair_grads.main(n=2000, reps=1, img_h=64, img_w=48,
                                 device="cpu")
    assert sorted(times) == sorted(
        (w, c) for w in gsplat_cuda.WINDOWS for c in time_pair_grads.CHUNKS)


_XLA_CASES = {
    # tiles over max_pairs_per_tile, translucent
    "overflow": dict(opaque=False, N=150, kw=dict(
        tile_size=16, max_pairs_per_tile=64, chunk=16, pair_budget_mult=4)),
    # opaque: T falls to ~3e-14 in some pixels (no early-out in this window)
    "opaque": dict(opaque=True, N=400, kw=dict(
        tile_size=16, max_pairs_per_tile=256, chunk=32, pair_budget_mult=4)),
}


@pytest.mark.parametrize("case", sorted(_XLA_CASES))
def test_render_vjp_matches_jax_xla_path(case):
    """render with use_pallas unset against the JAX XLA compositor
    (use_pallas unset) and its back-to-front backward: outputs rtol 1e-4,
    gradients rtol 1e-3 with atol 1e-3 of each gradient's largest entry.
    The port's backward replays the forward front to back and needs no
    clip where the XLA backward divides by reverse products clipped at
    1e-20; they agree at that tolerance even where T falls to ~3e-14."""
    spec = _XLA_CASES[case]
    rng = np.random.RandomState(5)
    H, W = 48, 64
    K, Rt, *prims = _scene(rng, 2, spec["N"], H, W, spec["opaque"])
    w = rng.rand(2, 3, H, W).astype(np.float32)

    def j_loss(*p):
        o = jg.render(W, H, jnp.asarray(K), jnp.asarray(Rt), *p,
                      **spec["kw"])
        return (o["render"] * w).sum() + o["alpha"].sum()

    ref_val, ref = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, prims))
    tp = [torch.from_numpy(a).requires_grad_(True) for a in prims]
    o = tg.render(W, H, torch.from_numpy(K), torch.from_numpy(Rt), *tp,
                  **spec["kw"])
    val = (o["render"] * torch.from_numpy(w)).sum() + o["alpha"].sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-4)
    if spec["opaque"]:
        assert float(o["final_T"].detach().min()) < 1e-10
    for name, t, r in zip(("primpos", "primqvec", "primscale", "opacity",
                           "colors"), tp, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all() and np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)
