"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them. On a machine with the card (which has no JAX, and tests/conftest.py
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K4 exact (integer scan); K1 atol 1e-4 / rtol 1e-4 on color and
transmittance (sequential compositing against the plain version's
per-chunk cumprod, float32) and the processed-block count exact. K3:
2e-6 of each row's largest running sum against a float64 scan, 1e-5
against the float32 torch.cumsum (float32 sums in other orders over up to
2^24 items). K2: rtol 1e-3 with atol 1e-4 of each column's
largest entry (the same float32 sums over a tile's pixels in other orders;
the suffix-from-total identity cancels terms as large as the column's
largest). Gradients of render on the card against the CPU: rtol 1e-3 with
atol 1e-3 of each gradient's largest entry.
"""

import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda as gc

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 31, 4096, 4097, 1 << 20, (1 << 24) + 5])
def test_cumsum1d_kernel_is_exact(cuda, n):
    """Sizes across one block, several blocks and three scan levels
    (4096^2 < n); totals far above 2^24 and negative entries included."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(-3, 50, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    before = dict(gc.LAUNCHES)
    got = gc.cumsum1d(x)
    assert gc.LAUNCHES["cumsum1d"] == before["cumsum1d"] + 1
    assert torch.equal(got, gc.cumsum1d_plain(x))


@pytest.mark.parametrize("f,m", [(1, 1), (3, 4097), (10, 1 << 20),
                                 (2, (1 << 24) + 5)])
def test_cumsum_cols_kernel_matches_plain(cuda, f, m):
    """One block, several blocks and three scan levels; every row against
    a float64 torch.cumsum relative to the row's largest running sum. The
    float32 torch.cumsum (the plain version) is itself up to ~6e-6 off that
    reference at 2^24 items, so the two float32 scans are held to 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(f, m, generator=g, device=cuda)
    before = dict(gc.LAUNCHES)
    got = gc.cumsum_cols(x)
    assert gc.LAUNCHES["cumsum_cols"] == before["cumsum_cols"] + 1
    ref = torch.cumsum(x.double(), dim=1)
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert float(((got.double() - ref).abs() / scale).max()) <= 2e-6
    plain = gc.cumsum_cols_plain(x)
    assert float(((got - plain).double().abs() / scale).max()) <= 1e-5


def _scene(rng, N, H, W, opaque):
    means = rng.randn(N, 3).astype(np.float32) * 0.3
    means[:, 2] += 2.5
    scales = (0.02 + 0.1 * rng.rand(N, 3)).astype(np.float32)
    quats = rng.randn(N, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    lo = 0.9 if opaque else 0.05
    opac = (rng.rand(N, 1) * (0.99 - lo) + lo).astype(np.float32)
    colors = rng.rand(N, 3).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    Rt = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    return K, Rt, means, quats, scales, opac, colors


@pytest.mark.parametrize("opaque,maxpp,chunk,ts", [
    (False, 256, 32, 16),   # no overflow
    (True, 64, 16, 16),     # overflowing tiles and the T early-out
    (True, 128, 32, 32),    # 1024-thread blocks, ragged image edge
])
def test_compositor_kernel_matches_plain(cuda, opaque, maxpp, chunk, ts):
    H, W = 72, 100
    arrays = [torch.from_numpy(a).to(cuda) for a in _scene(
        np.random.RandomState(ts + maxpp), 400, H, W, opaque)]
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *arrays, H, W, ts, pair_budget=1600)
    ntx, nty = -(-W // ts), -(-H // ts)
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             b.sorted_prim, (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
              max_pairs_per_tile=maxpp)
    img, T, cnt = gc.compositor_fwd(rows, b.tile_start, b.tile_end, **kw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, b.tile_start,
                                                b.tile_end, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, p_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(T, p_T, atol=1e-4, rtol=1e-4)
    assert torch.equal(cnt, p_cnt)
    if opaque:
        assert int((b.tile_end - b.tile_start).max()) > maxpp


@pytest.mark.parametrize("opaque,maxpp,chunk,ts", [
    (False, 256, 32, 16),   # no overflow
    (True, 64, 16, 16),     # overflowing tiles and the T early-out
    (True, 128, 32, 32),    # 1024-thread blocks, ragged image edge
    (False, 64, 16, 8),     # 64-thread blocks: two passes of the column sum
])
def test_pair_grads_kernel_matches_plain(cuda, opaque, maxpp, chunk, ts):
    H, W = 72, 100
    arrays = [torch.from_numpy(a).to(cuda) for a in _scene(
        np.random.RandomState(ts + maxpp), 400, H, W, opaque)]
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *arrays, H, W, ts, pair_budget=1600)
    ntx, nty = -(-W // ts), -(-H // ts)
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             b.sorted_prim, (maxpp // chunk + 1) * chunk)
    img, T, cnt = gc.compositor_fwd(
        rows, b.tile_start, b.tile_end, img_h=H, img_w=W, tile_size=ts,
        ntx=ntx, nty=nty, chunk=chunk, max_pairs_per_tile=maxpp)
    g = torch.Generator(device=cuda).manual_seed(0)
    d_out = torch.randn(img.shape, generator=g, device=cuda)
    d_T = torch.randn(T.shape, generator=g, device=cuda)
    args = (rows, b.tile_start, b.tile_end, cnt, d_out, d_T, T, img, ts, ntx,
            nty, chunk, 1600)
    before = dict(gc.LAUNCHES)
    got = gc.pair_grads(*args)
    assert gc.LAUNCHES["pair_grads"] == before["pair_grads"] + 1
    ref = gc.pair_grads_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (1600, 16)
    assert float(ref.abs().max()) > 1e-3
    for k in range(16):
        scale = float(ref[:, k].abs().max())
        torch.testing.assert_close(got[:, k], ref[:, k], rtol=1e-3,
                                   atol=1e-4 * scale, msg=lambda m: f"{k}: {m}")
    # rows no tile composited stay zero in both
    assert torch.equal(got.abs().sum(1) == 0, ref.abs().sum(1) == 0)


def test_render_gradients_on_the_card_match_the_cpu(cuda):
    """The whole VJP of render (K1, K2, K3 and K4 on the card) against the
    CPU (plain versions) on the same scene."""
    scene = [torch.from_numpy(np.stack([a, a])) for a in _scene(
        np.random.RandomState(8), 300, 64, 80, False)]
    kw = dict(tile_size=16, max_pairs_per_tile=256, chunk=32)
    w = torch.from_numpy(np.random.RandomState(9).rand(2, 3, 64, 80)
                         .astype(np.float32))
    grads = []
    for dev in (torch.device("cpu"), cuda):
        K, Rt, *prims = [t.to(dev) for t in scene]
        prims = [t.clone().requires_grad_(True) for t in prims]
        o = tg.render(80, 64, K, Rt, *prims, **kw)
        ((o["render"] * w.to(dev)).sum() + o["alpha"].sum()
         + 0.1 * o["depth"].sum()).backward()
        grads.append([t.grad.cpu() for t in prims])
    for ref, got in zip(*grads):
        assert bool(torch.isfinite(ref).all()) and float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, rtol=1e-3,
                                   atol=1e-3 * float(ref.abs().max()))


def test_indexed_add_takes_the_sorted_branch_on_the_card(cuda):
    """ops/scatter.py on CUDA tensors: sparse targets (fewer than 8 updates
    each on average) go through the sort and the scans K3 and K4, dense
    targets through index_add_; both equal index_add_ to 1e-5 of the
    largest running sum of the sorted updates."""
    from goliath_torch.ops import scatter

    g = torch.Generator(device=cuda).manual_seed(3)
    P, C = 200_000, 3
    vals = torch.randn(C, P, generator=g, device=cuda)
    for N, sorted_branch in ((50_000, True), (1_000, False)):
        idx = torch.randint(-10, N + 10, (P,), generator=g, device=cuda,
                            dtype=torch.int32)
        before = dict(gc.LAUNCHES)
        got = scatter.indexed_add_cf(idx, vals, N)
        assert (gc.LAUNCHES["cumsum_cols"] - before["cumsum_cols"],
                gc.LAUNCHES["cumsum1d"] - before["cumsum1d"]) == (
                    (1, 1) if sorted_branch else (0, 0))
        ok = (idx >= 0) & (idx < N)
        ref = torch.zeros(C, N, device=cuda).index_add_(
            1, idx[ok].long(), vals[:, ok])
        order = torch.sort(torch.where(ok, idx, N))[1]
        run_max = float(torch.cumsum(
            torch.where(ok, vals, 0.0)[:, order].double(), 1).abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * run_max


def test_render_on_the_card_matches_the_cpu(cuda):
    """The whole forward render: CUDA tensors (kernels) against CPU tensors
    (plain versions) on the same scene."""
    scene = [torch.from_numpy(np.stack([a, a])) for a in _scene(
        np.random.RandomState(7), 300, 64, 80, False)]
    kw = dict(tile_size=16, max_pairs_per_tile=256, chunk=32)
    ref = tg.render(80, 64, *scene, **kw)
    got = tg.render(80, 64, *[t.to(cuda) for t in scene], **kw)
    for k in ref:
        torch.testing.assert_close(got[k].cpu(), ref[k], atol=1e-4,
                                   rtol=1e-4)
