"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them. On a machine with the card (which has no JAX, and tests/conftest.py
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K4 exact (integer scan, wrapping in 32 bits as torch.cumsum);
K5 exact, face index and depth (the
same float32 operations, each rounded on its own, in the same order; its
cull skips misses only); K3 bit-identical from call to call; K1 atol 1e-4 / rtol 1e-4 on color and
transmittance (sequential compositing against the plain version's
per-chunk cumprod, float32) and the processed-block count exact. K3:
2e-6 of each row's largest running sum against a float64 scan, 1e-5
against the float32 torch.cumsum (float32 sums in other orders over up to
2^24 items). K2: rtol 1e-3 with atol 1e-4 of each column's
largest entry (the same float32 sums over a tile's pixels in other orders;
the suffix-from-total identity cancels terms as large as the column's
largest). K6 (K1 and K2 with an image axis) and the XLA block window of K1
and K2: as K1 and K2. K7: as K3 against a float64 scan, against
torch.cumsum(x, 0) within that call's own distance from the float64 scan
plus 2e-6, and bit-identical from call to call. P1: ``full`` equal to K1
bit for bit, the other variants as K1 against their plain versions. Gradients of render on
the card against the CPU: rtol 1e-3 with atol 1e-3 of each gradient's
largest entry. The mesh RenderLayer on the card
against the CPU: the same coverage, the same face on >= 99.9% of the
pixels, the image at atol/rtol 1e-4 where the face agrees. The OLAT
teacher's deep shadows (the card's shadow integrals on K9): the cell binning
exact, the density grid at rtol 1e-5 plus 1e-6 of its largest value, the
shadow integrals at rtol 1e-5 plus 1e-5, the small teacher forward at rtol
1e-3 plus 1e-3 of each output's largest value. K8 against its plain
version on the card: rgba at rtol 1e-4 plus 1e-6 of the largest value
(the plain deposit's atomics sum in other orders), the in-group counts
exact; K10 against its plain version on the same inputs and a seeded
upstream gradient: each gradient at rtol 1e-3 plus 1e-3 of its largest
value (float atomics sum in a changing order); K9 against its plain
version at rtol 1e-5 plus 1e-6 of the largest value. The envmap functions
(plain PyTorch on both sides) at rtol 1e-4 plus 1e-4 of the largest value; the
small relight spin frame as chip_smoke.py's reference (rtol 1e-3 plus 1e-3
of each part's largest entry; the composite panel's mirrorball inset and
the rest of it are held apart). parallel/: K1 and K4 at a band's shapes as
above; the band and slab renders, outputs and gradients, card against CPU
as render's gradients; the sharded RGCA step card against CPU at rtol 1e-3
with atol 1e-3 of each gradient's largest entry, or within 4 times its
spread (its one-ulp move on the card, or the unsharded step's own
card-to-CPU distance); across distinct devices (the card and the host,
and two cards where there are), each family's step of the dry run against
the unsharded step on the card by chip_smoke.py's rule (hold_sharded_step:
the same rtol 1e-3 rule and spread, the spread measured on the unsharded
step alone: its one-ulp moves, its reruns and, with the host in the mesh,
its card-to-host distance; the replicas holding the step's parameters and
the model's buffers bit for bit, the card's launches exact; the same for
the RGCA step on 2-D meshes whose data shards band their renders over
their own rows), the bands' loss within the dry run's
1e-4 and the slabs as tests/test_torch_parallel_prim.py holds them
(outputs atol 5e-5, gradients 2e-4 of their largest entry). The layer
library's modules card against CPU as
chip_smoke.py's lib_card_vs_cpu holds them (float32 outputs at LIB_TOL and
gradients at LIB_GRAD_TOL; with leaky ReLUs, float64 outputs and gradients
at LIB_F64_TOL); the render example's grid on the card within 1 LSB of
uint8 of the CPU's.
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


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, (1 << 26) + 3])
def test_cumsum1d_single_pass_is_exact(cuda, n):
    """K4's single pass: no item, one item, one tile of 4096 items and one
    either side, and 16,385 tiles, far more than the card holds at once;
    one launch per call (none for no item). Bit-equal to torch.cumsum."""
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randint(-5, 1000, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    before = gc.LAUNCHES["cumsum1d"]
    got = gc.cumsum1d(x)
    assert gc.LAUNCHES["cumsum1d"] == before + (n > 0)
    assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))


def test_cumsum1d_on_reused_scratch(cuda):
    """50 calls in a row, on two sizes in turn, so that the caching
    allocator hands each call flag words a call before it used: every
    result bit-equal to torch.cumsum. A slice at an odd offset takes the
    scalar loads."""
    g = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randint(0, 64, (m,), generator=g, device=cuda,
                        dtype=torch.int32) for m in (1_048_576, 3_145_728)]
    refs = [torch.cumsum(x, 0, dtype=torch.int32) for x in xs]
    outs = [gc.cumsum1d(xs[i % 2]) for i in range(50)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, refs[i % 2]), i
    odd = xs[0][3:200_003]
    assert torch.equal(gc.cumsum1d(odd), torch.cumsum(odd, 0,
                                                      dtype=torch.int32))


def test_cumsum1d_wraps_as_torch_cumsum(cuda):
    """Totals past 2^31 (and past 2^32) wrap in 32 bits as
    torch.cumsum(dtype=int32) does."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randint(1 << 28, 1 << 30, (300_000,), generator=g,
                      device=cuda, dtype=torch.int32)
    ref = torch.cumsum(x, 0, dtype=torch.int32)
    assert int(x.long().sum()) > 1 << 32 and bool((ref < 0).any())
    assert torch.equal(gc.cumsum1d(x), ref)


@pytest.mark.parametrize("f,m", [(1, 1), (3, 4097), (10, 1 << 20),
                                 (2, (1 << 24) + 5)])
def test_cumsum_cols_kernel_matches_plain(cuda, f, m):
    """One tile, several tiles and 4097 tiles of 4096 items; every row
    against a float64 torch.cumsum relative to the row's largest running
    sum. The float32 torch.cumsum (the plain version) is itself up to ~6e-6
    off that reference at 2^24 items, so the two float32 scans are held to
    1e-5."""
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


def _hold_k3(x):
    """K3 on x: one launch, held as test_cumsum_cols_kernel_matches_plain
    holds it."""
    before = gc.LAUNCHES["cumsum_cols"]
    got = gc.cumsum_cols(x)
    assert gc.LAUNCHES["cumsum_cols"] == before + 1
    ref = torch.cumsum(x.double(), dim=1)
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert float(((got.double() - ref).abs() / scale).max()) <= 2e-6
    plain = gc.cumsum_cols_plain(x)
    assert float(((got - plain).double().abs() / scale).max()) <= 1e-5
    return got


@pytest.mark.parametrize("m", [1, 3, 4095, 4096, 4097, 8190, 3 * 4096 + 2])
def test_cumsum_cols_at_tile_edges(cuda, m):
    """Around K3's tile of 4096 items, with rows that start unaligned (m
    not a multiple of 4: rows 1 and 2 of [3, m] take scalar loads) and an
    input whose every row starts 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(m + 7)
    x = torch.randn(3, m, generator=g, device=cuda)
    _hold_k3(x)
    shifted = torch.randn(3 * m + 1, generator=g, device=cuda)[1:].view(3, m)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    _hold_k3(shifted)


@pytest.mark.parametrize("f,m", [(10, 1 << 20), (2, (1 << 24) + 5)])
def test_cumsum_cols_is_deterministic(cuda, f, m):
    """K3 folds its float64 carry in tile order, so its bits do not depend
    on which predecessor's prefix a tile's look-back found: 20 calls while
    another stream keeps the card busy with matrix products, all
    bit-identical to a first call on an idle card."""
    g = torch.Generator(device=cuda).manual_seed(f * m)
    x = torch.randn(f, m, generator=g, device=cuda) + 0.25
    first = _hold_k3(x)
    torch.cuda.synchronize()
    a = torch.randn(4096, 4096, generator=g, device=cuda) / 64.0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            a = torch.tanh(a @ a)
    outs = [gc.cumsum_cols(x) for _ in range(20)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out.view(torch.int32), first.view(torch.int32)), i


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
    args = (rows, b.tile_start, b.tile_end, cnt, d_out, d_T, T, ts, ntx, nty,
            chunk, 1600)
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


def _mesh_scene(dev, H, W, n_lat, n_lon):
    from goliath_torch.data.synthetic import make_camera_ring, \
        make_sphere_mesh
    from goliath_torch.ops import rasterizer as tr

    v, vi, _vt, _vti = make_sphere_mesh(n_lat, n_lon)
    K, Rt, _ = make_camera_ring(3, H, W)
    v_pix = tr.transform(torch.from_numpy(v[None]).expand(3, -1, -1),
                         torch.from_numpy(K), torch.from_numpy(Rt))
    return v_pix[1].to(dev), torch.from_numpy(vi).to(dev)


@pytest.mark.parametrize("mfpt,chunk,ts,H,W", [
    (256, 32, 16, 72, 100),   # no overflow
    (16, 8, 16, 72, 100),     # overflowing tiles: the chunk-aligned window
    (64, 32, 32, 72, 100),    # 1024-thread blocks, ragged image edge
    (64, 32, 8, 72, 100),     # tile 8: two warps of 8x4 a tile
    (64, 32, 16, 61, 93),     # ragged image edges at tile 16
    (64, 16, 12, 61, 93),     # tile 12: row order, a partial last warp
])
def test_zbuffer_kernel_matches_plain(cuda, mfpt, chunk, ts, H, W):
    """K5 against its plain version on the same face rows: the face index
    and the depth equal bit for bit (both round each product and sum on its
    own, in the TPU kernel's order; the kernel's cull skips misses only)."""
    from goliath_torch.ops import rasterizer as tr
    from goliath_torch.ops import rasterizer_cuda as rc

    v_pix, vi = _mesh_scene(cuda, H, W, 16, 32)
    rows, b = tr.bin_faces(v_pix, vi, H, W, ts)
    args = (rows, b.sorted_prim, b.tile_start, b.tile_end, H, W, ts,
            b.num_tiles_x, b.num_tiles_y, chunk, mfpt)
    before = dict(gc.LAUNCHES)
    idx, z = rc.zbuffer(*args)
    assert gc.LAUNCHES["zbuffer"] == before["zbuffer"] + 1
    p_idx, p_z = rc.zbuffer_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx, p_idx)
    assert torch.equal(z.view(torch.int32), p_z.view(torch.int32))
    assert float((idx >= 0).float().mean()) > 0.1
    if mfpt == 16:
        assert int((b.tile_end - b.tile_start).max()) > mfpt


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_zbuffer_kernel_on_slivers_at_full_screen_coordinates(cuda, ts):
    """K5 against its plain version on random faces and slivers spread
    over a 2048x1334 screen, where the edge functions round the most: face
    index and depth bit-equal."""
    from goliath_torch.ops import rasterizer as tr
    from goliath_torch.ops import rasterizer_cuda as rc

    H, W, n = 1334, 2048, 400
    rng = np.random.default_rng(ts)
    p0 = rng.uniform([0, 0], [W, H], (n, 2))
    p1 = p0 + rng.normal(0, 20, (n, 2))
    p2 = p0 + rng.normal(0, 20, (n, 2))
    p2[::2] = p0[::2] + rng.uniform(0.2, 0.8, (n // 2, 1)) * (
        p1[::2] - p0[::2]) + rng.normal(0, 0.05, (n // 2, 2))
    corners = np.stack([p0, p1, p2], 1)
    z = rng.uniform(1.0, 10.0, (n, 3, 1))
    v_pix = torch.from_numpy(np.concatenate([corners, z], -1).reshape(
        -1, 3).astype(np.float32)).to(cuda)
    vi = torch.arange(3 * n, device=cuda).reshape(n, 3)
    rows, b = tr.bin_faces(v_pix, vi, H, W, ts)
    args = (rows, b.sorted_prim, b.tile_start, b.tile_end, H, W, ts,
            b.num_tiles_x, b.num_tiles_y, 32, 256)
    idx, z = rc.zbuffer(*args)
    p_idx, p_z = rc.zbuffer_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx, p_idx)
    assert torch.equal(z.view(torch.int32), p_z.view(torch.int32))
    assert int((idx >= 0).sum()) > 10_000


def test_render_layer_on_the_card_matches_the_cpu(cuda):
    """RenderLayer (K4 and K5 on the card) against the CPU (plain versions):
    the same coverage, the same face on all but tie pixels of shared edges
    (v_pix is rounded differently by the card's batched matrix products),
    and the image at atol/rtol 1e-4 where the face agrees."""
    from goliath_torch.data.synthetic import make_camera_ring, \
        make_sphere_mesh
    from goliath_torch.ops import rasterizer as tr

    H, W = 72, 100
    v, vi, vt, vti = make_sphere_mesh(16, 32)
    K, Rt, _ = make_camera_ring(2, H, W)
    tex = np.random.RandomState(5).rand(2, 3, 32, 32).astype(np.float32)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        rl = tr.RenderLayer(H, W, vi, vt, vti, device=dev)
        outs.append(rl(torch.from_numpy(np.stack([v, v])).to(dev),
                       torch.from_numpy(tex).to(dev),
                       torch.from_numpy(K).to(dev),
                       torch.from_numpy(Rt).to(dev)))
    ref, got = outs[0], {k: t.cpu() for k, t in outs[1].items()}
    assert torch.equal(ref["index_img"] == -1, got["index_img"] == -1)
    same = ref["index_img"] == got["index_img"]
    assert float(same.float().mean()) >= 0.999
    m = same[:, None]
    torch.testing.assert_close(got["render"] * m, ref["render"] * m,
                               atol=1e-4, rtol=1e-4)


def _fold_frame(cuda, B, maxpp, chunk, ts, opaque, n_chan=None):
    """B images' prims binned once over the images stacked in tile space
    (ops.gsplat._render_folded's binning), with their pair rows (the first
    ``n_chan`` channels of the colors, all where it is None)."""
    H, W = 72, 100
    scenes = [_scene(np.random.RandomState(20 + b), 300, H, W, opaque)
              for b in range(B)]
    K, Rt, *prims = [torch.from_numpy(np.stack(a)).to(cuda)
                     for a in zip(*scenes)]
    ntx, nty = -(-W // ts), -(-H // ts)
    captured = {}
    orig = gc.rasterize_tiled

    def spy(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        return orig(*a, **kw)

    gc.rasterize_tiled = spy
    try:
        with torch.no_grad():
            tg._render_folded(W, H, K, Rt, *prims, True, ts, 1.0, 0.1, 64,
                              maxpp, chunk, 4, ntx, nty)
    finally:
        gc.rasterize_tiled = orig
    (xys, conics, op_s, chan, valid, sorted_prim, start, end, *_rest) = \
        captured["args"]
    assert captured["kw"]["n_imgs"] == B
    rows = gc.pack_pair_rows(xys, conics, op_s, chan[:, :n_chan],
                             valid.float(),
                             sorted_prim, (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
              max_pairs_per_tile=maxpp, n_imgs=B)
    return rows, start, end, sorted_prim.shape[0], kw


@pytest.mark.parametrize("B,maxpp,chunk,ts,opaque", [
    (2, 256, 32, 16, False),
    (3, 64, 16, 16, True),     # overflowing tiles and the T early-out
    (3, 128, 32, 32, True),    # 1024-thread blocks, ragged image edge
])
def test_fold_kernels_match_plain(cuda, B, maxpp, chunk, ts, opaque):
    """K6 forward and backward (K1 and K2 over the B stacked images, one
    launch each) against their plain versions."""
    rows, start, end, n_pairs, kw = _fold_frame(cuda, B, maxpp, chunk, ts,
                                                opaque)
    before = dict(gc.LAUNCHES)
    img, T, cnt = gc.compositor_fwd(rows, start, end, **kw)
    assert gc.LAUNCHES["compositor_fwd_fold"] == \
        before["compositor_fwd_fold"] + 1
    assert gc.LAUNCHES["compositor_fwd"] == before["compositor_fwd"]
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, start, end, **kw)
    torch.cuda.synchronize()
    assert img.shape == (B, 4, 72, 100) and T.shape == (B, 72, 100)
    torch.testing.assert_close(img, p_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(T, p_T, atol=1e-4, rtol=1e-4)
    assert torch.equal(cnt, p_cnt)
    g = torch.Generator(device=cuda).manual_seed(1)
    d_out = torch.randn(img.shape, generator=g, device=cuda)
    d_T = torch.randn(T.shape, generator=g, device=cuda)
    args = (rows, start, end, cnt, d_out, d_T, T, ts, kw["ntx"], kw["nty"],
            chunk, n_pairs, B)
    got = gc.pair_grads(*args)
    assert gc.LAUNCHES["pair_grads_fold"] == before["pair_grads_fold"] + 1
    ref = gc.pair_grads_plain(*args)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 1e-3
    for k in range(16):
        scale = float(ref[:, k].abs().max())
        torch.testing.assert_close(got[:, k], ref[:, k], rtol=1e-3,
                                   atol=1e-4 * scale, msg=lambda m: f"{k}: {m}")
    assert torch.equal(got.abs().sum(1) == 0, ref.abs().sum(1) == 0)
    if opaque:
        assert int((end - start).max()) > maxpp


@pytest.mark.parametrize("maxpp,chunk,ts", [(64, 16, 16), (128, 32, 32)])
def test_xla_window_kernels_match_plain(cuda, maxpp, chunk, ts):
    """K1 and K2 in the XLA compositor's window (no early-out), with
    overflowing tiles, against their plain versions."""
    H, W = 72, 100
    arrays = [torch.from_numpy(a).to(cuda) for a in _scene(
        np.random.RandomState(ts + maxpp), 400, H, W, True)]
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *arrays, H, W, ts, pair_budget=1600)
    assert int((b.tile_end - b.tile_start).max()) > maxpp
    ntx, nty = -(-W // ts), -(-H // ts)
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             b.sorted_prim, (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
              max_pairs_per_tile=maxpp, window="xla")
    before = dict(gc.LAUNCHES)
    img, T, cnt = gc.compositor_fwd(rows, b.tile_start, b.tile_end, **kw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, b.tile_start,
                                                b.tile_end, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, p_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(T, p_T, atol=1e-4, rtol=1e-4)
    assert torch.equal(cnt, p_cnt)
    assert float(T.min()) < 1e-4      # past the Pallas kernels' early-out
    g = torch.Generator(device=cuda).manual_seed(0)
    d_out = torch.randn(img.shape, generator=g, device=cuda)
    d_T = torch.randn(T.shape, generator=g, device=cuda)
    args = (rows, b.tile_start, b.tile_end, cnt, d_out, d_T, T, ts, ntx, nty,
            chunk, 1600)
    got = gc.pair_grads(*args, window="xla")
    ref = gc.pair_grads_plain(*args, window="xla")
    torch.cuda.synchronize()
    for k in range(16):
        scale = float(ref[:, k].abs().max())
        torch.testing.assert_close(got[:, k], ref[:, k], rtol=1e-3,
                                   atol=1e-4 * scale, msg=lambda m: f"{k}: {m}")
    assert {k: gc.LAUNCHES[k] - before[k] for k in before
            if gc.LAUNCHES[k] != before[k]} == {"compositor_fwd_xla": 1,
                                                "pair_grads_xla": 1}


def _hold_k7(x):
    """K7 on x: one launch; against a float64 scan (2e-6 of each column's
    largest running sum, the scan taken along the last dim of a transposed
    copy) and against the float32 torch.cumsum(x, 0), its plain version,
    within that version's own distance from the float64 scan plus 2e-6:
    along dim 0 torch.cumsum adds sequentially and drifts further (6.6e-5
    of the running sum at 2^24 rows on the card) than K7's tiles."""
    before = gc.LAUNCHES["cumsum_rows"]
    got = gc.cumsum_rows(x)
    assert gc.LAUNCHES["cumsum_rows"] == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    ref = torch.cumsum(x.t().contiguous().double(), 1)
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((got.t().double() - ref).abs() / scale).max()) <= 2e-6
    plain = gc.cumsum_rows_plain(x)
    own = float(((plain.t().double() - ref).abs() / scale).max())
    assert float(((got - plain).t().double().abs() / scale).max()) <= (
        own + 2e-6)
    return got


@pytest.mark.parametrize("m,f", [
    (1, 10), (4097, 10), (1000003, 3), ((1 << 24) + 5, 2),
    *[(1, f) for f in (1, 3, 16, 33)],
    *[(m, f) for f in (1, 3, 10, 16, 33)
      for m in ("R-1", "R", "R+1", "2R+1")]])
def test_cumsum_rows_kernel_matches_plain(cuda, m, f):
    """K7 on ragged M: long chains of tiles (1,000,003 rows at F = 3 and
    2^24 + 5 at F = 2, past the look-back's window of 32 tiles, with a
    ragged last tile) and M around its tile of R rows (R depends on F: the
    binding reports it), at F = 1 (one column a tile of 8 warps), 3, 10 (a
    warp a column), 16 and 33 (two windows of columns, scalar loads)."""
    if isinstance(m, str):
        R = gc.load_kernels().cumsum_rows_tile_rows(f)
        m = {"R-1": R - 1, "R": R, "R+1": R + 1, "2R+1": 2 * R + 1}[m]
    g = torch.Generator(device=cuda).manual_seed(m)
    _hold_k7(torch.randn(m, f, generator=g, device=cuda))


def test_cumsum_rows_kernel_on_an_unaligned_row_slice(cuda):
    """x[1:] of an F = 3 tensor starts 12 bytes past a 16-byte boundary:
    scalar loads and stores, the same results."""
    g = torch.Generator(device=cuda).manual_seed(3)
    R = gc.load_kernels().cumsum_rows_tile_rows(3)
    base = torch.randn(3 * R + 8, 3, generator=g, device=cuda)
    x = base[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 12
    got = _hold_k7(x)
    aligned = gc.cumsum_rows(x.clone())
    assert torch.equal(got.view(torch.int32), aligned.view(torch.int32))


@pytest.mark.parametrize("shape", [(0, 10), (7, 0), (0, 0)])
def test_cumsum_rows_empty_input_launches_nothing(cuda, shape):
    """No row or no column: an empty result of the input's shape, and no
    launch counted."""
    before = gc.LAUNCHES["cumsum_rows"]
    got = gc.cumsum_rows(torch.empty(shape, device=cuda))
    assert gc.LAUNCHES["cumsum_rows"] == before
    assert got.shape == shape and got.is_cuda


@pytest.mark.parametrize("m,f", [(3_145_728, 10), ((1 << 24) + 5, 2)])
def test_cumsum_rows_is_deterministic(cuda, m, f):
    """K7 folds its float64 carry in tile order, as K3: 20 calls while
    another stream keeps the card busy with matrix products, all
    bit-identical to a first call on an idle card."""
    g = torch.Generator(device=cuda).manual_seed(f * m)
    x = torch.randn(m, f, generator=g, device=cuda) + 0.25
    first = _hold_k7(x)
    torch.cuda.synchronize()
    a = torch.randn(4096, 4096, generator=g, device=cuda) / 64.0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            a = torch.tanh(a @ a)
    outs = [gc.cumsum_rows(x) for _ in range(20)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out.view(torch.int32), first.view(torch.int32)), i


@pytest.mark.parametrize("opaque,maxpp,chunk,ts", [
    (False, 256, 32, 16), (True, 64, 16, 16), (True, 128, 32, 32)])
def test_probe_variants_match_plain(cuda, opaque, maxpp, chunk, ts):
    """P1: full equal to K1 bit for bit; each variant against its plain
    version at K1's tolerance, over K1's blocks."""
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
    for v in gc.PROBE_VARIANTS:
        before = gc.LAUNCHES[f"probe_{v}"]
        got = gc.probe_fwd(rows, b.tile_start, b.tile_end, cnt, variant=v,
                           **kw)
        assert gc.LAUNCHES[f"probe_{v}"] == before + 1
        ref = gc.compositor_fwd_plain(rows, b.tile_start, b.tile_end,
                                      variant=v, replay_cnt=cnt, **kw)
        torch.cuda.synchronize()
        if v == "full":
            assert all(torch.equal(x, y) for x, y in zip(got, (img, T, cnt)))
        for k in range(2):
            torch.testing.assert_close(got[k], ref[k], atol=1e-4, rtol=1e-4,
                                       msg=lambda m: f"{v} output {k}: {m}")
        assert torch.equal(got[2], ref[2]), v


def test_fold_render_gradients_on_the_card_match_the_cpu(cuda, monkeypatch):
    """The whole batch-folded render and its VJP (K6, K3 and K4 on the
    card) against the CPU (plain versions)."""
    monkeypatch.setenv("GOLIATH_GSPLAT_FOLD", "1")
    scene = [torch.from_numpy(np.stack(a)) for a in zip(*(
        _scene(np.random.RandomState(8 + b), 300, 64, 80, False)
        for b in range(3)))]
    kw = dict(tile_size=16, max_pairs_per_tile=256, chunk=32,
              use_pallas=True)
    w = torch.from_numpy(np.random.RandomState(9).rand(3, 3, 64, 80)
                         .astype(np.float32))
    grads, outs = [], []
    for dev in (torch.device("cpu"), cuda):
        K, Rt, *prims = [t.to(dev) for t in scene]
        prims = [t.clone().requires_grad_(True) for t in prims]
        before = dict(gc.LAUNCHES)
        o = tg.render(80, 64, K, Rt, *prims, **kw)
        ((o["render"] * w.to(dev)).sum() + o["alpha"].sum()
         + 0.1 * o["depth"].sum()).backward()
        if dev.type == "cuda":
            assert gc.LAUNCHES["compositor_fwd_fold"] == \
                before["compositor_fwd_fold"] + 1
            assert gc.LAUNCHES["pair_grads_fold"] == \
                before["pair_grads_fold"] + 1
        outs.append({k: v.detach().cpu() for k, v in o.items()})
        grads.append([t.grad.cpu() for t in prims])
    for k in outs[0]:
        torch.testing.assert_close(outs[1][k], outs[0][k], atol=1e-4,
                                   rtol=1e-4)
    for ref, got in zip(*grads):
        assert bool(torch.isfinite(ref).all()) and float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, rtol=1e-3,
                                   atol=1e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("ts", [8, 16, 24, 32])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("window,n_imgs", [("pallas", 1), ("xla", 1),
                                           ("pallas", 3)])
def test_compositor_backward_cases(cuda, ts, C, window, n_imgs):
    """The compositor backward (K2, its XLA window, K6's backward) at tile
    sizes 8 (one warp, 2 pixels a thread), 24 (9 warps of 8x8 regions, 2
    pixels a thread), 16 and 32 (4 pixels a thread),
    C = 1 and 4, overflowing tiles, an image width (100) that is no multiple
    of the tile, and tiles with cnt = 0 (one of them forced on a tile with
    pairs, whose rows must stay zero), against pair_grads_plain; two
    launches give identical bits."""
    H, W, maxpp, chunk = 72, 100, 64, 16
    if n_imgs == 1:
        arrays = [torch.from_numpy(a).to(cuda) for a in _scene(
            np.random.RandomState(11), 400, H, W, True)]
        xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
            *arrays, H, W, ts, pair_budget=4000)
        rows = gc.pack_pair_rows(xys, conics, op_s, chan[:, :C],
                                 valid.float(), b.sorted_prim,
                                 (maxpp // chunk + 1) * chunk)
        start, end, n_pairs = b.tile_start, b.tile_end, 4000
        kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=-(-W // ts),
                  nty=-(-H // ts), chunk=chunk, max_pairs_per_tile=maxpp,
                  window=window)
    else:
        rows, start, end, n_pairs, kw = _fold_frame(cuda, n_imgs, maxpp,
                                                    chunk, ts, True, C)
    img, T, cnt = gc.compositor_fwd(rows, start, end, **kw)
    pairs = end - start
    assert int(pairs.max()) > maxpp and W % ts
    cnt = cnt.clone()
    forced = int(torch.nonzero(pairs > 0)[0])
    cnt[forced] = 0
    g = torch.Generator(device=cuda).manual_seed(ts + C + n_imgs)
    d_out = torch.randn(img.shape, generator=g, device=cuda)
    d_T = torch.randn(T.shape, generator=g, device=cuda)
    args = (rows, start, end, cnt, d_out, d_T, T, ts, kw["ntx"], kw["nty"],
            chunk, n_pairs, n_imgs, window)
    key = "pair_grads" + ("_fold" if n_imgs > 1 else "") \
        + ("_xla" if window == "xla" else "")
    before = gc.LAUNCHES[key]
    got = gc.pair_grads(*args)
    assert gc.LAUNCHES[key] == before + 1
    ref = gc.pair_grads_plain(*args)
    again = gc.pair_grads(*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n_pairs, 16)
    assert float(ref.abs().max()) > 1e-3
    for k in range(16):
        scale = float(ref[:, k].abs().max())
        torch.testing.assert_close(got[:, k], ref[:, k], rtol=1e-3,
                                   atol=1e-4 * scale, msg=lambda m: f"{k}: {m}")
    assert torch.equal(got.abs().sum(1) == 0, ref.abs().sum(1) == 0)
    assert not got[int(start[forced]):int(end[forced])].any()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _forward_frame(cuda, ts, C, n_imgs, maxpp, chunk, seed):
    """Pair rows [R, 8 + C] made by hand for n_imgs images of 72x100 at tile
    size ts, and their tile bounds: per tile a random number of random
    rows (none in some tiles, more than max_pairs_per_tile in others); the
    first tile of each image empty at row 0, so cnt = 0 there in both
    windows; and at the head of the second tile 24 opaque half-planes
    (sigma = b dx dy with a = c = 0, opacity 1) that drive its top 8 pixel
    rows, whole warps, to T == 0 exactly while the rows below go on."""
    H, W = 72, 100
    ntx, nty = -(-W // ts), -(-H // ts)
    rng = np.random.RandomState(seed)
    blocks, counts = [], []
    for _img in range(n_imgs):
        for t in range(ntx * nty):
            n = [0, int(rng.randint(1, maxpp)),
                 int(rng.randint(maxpp, 3 * maxpp))][rng.randint(3)]
            n = 0 if t == 0 else 24 + 2 * maxpp if t == 1 else n
            x0, y0 = (t % ntx) * ts, (t // ntx) * ts
            r = np.zeros((n, 8 + C), np.float32)
            r[:, 0] = x0 + rng.uniform(-0.5, 1.5, n) * ts
            r[:, 1] = y0 + rng.uniform(-0.5, 1.5, n) * ts
            r[:, 2] = rng.uniform(0.02, 0.3, n)
            r[:, 3] = rng.uniform(-0.01, 0.01, n)
            r[:, 4] = rng.uniform(0.02, 0.3, n)
            r[:, 5] = rng.uniform(0.05, 0.6, n)
            r[:, 8:] = rng.randn(n, C)
            if t == 1:
                r[:24, :6] = [x0 - 100.0, y0 + 8.0, 0.0, -1e-7, 0.0, 1.0]
            blocks.append(r)
            counts.append(n)
    pad = np.zeros(((maxpp // chunk + 1) * chunk, 8 + C), np.float32)
    rows = torch.from_numpy(np.concatenate(blocks + [pad])).to(cuda)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=cuda)
    starts = ends - torch.tensor(counts, dtype=torch.int32, device=cuda)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
              max_pairs_per_tile=maxpp, n_imgs=n_imgs)
    return rows, starts, ends, kw


@pytest.mark.parametrize("ts", [8, 12, 16, 24, 32])
@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("window,n_imgs", [("pallas", 1), ("xla", 1),
                                           ("pallas", 3)])
def test_compositor_forward_cases(cuda, ts, C, window, n_imgs):
    """K1 (its XLA window, K6's forward) at tile sizes 8 (one warp of 8x8,
    2 pixels a thread), 24 (9 warps of 8x8), 16 and 32 (16x8 regions, 4
    pixels a thread) and 12 (one pixel a thread, 144 pixels on 5 warps),
    C = 1, 4 and 8, on hand-made rows with cnt = 0 tiles, overflowing
    tiles, a width (100) that is no multiple of the tile, and whole warps
    at T == 0 that the kernel skips (the plain version counts the skipped
    visits; a one-warp tile saturates whole and stops at the Pallas
    early-out instead): against compositor_fwd_plain (atol/rtol 1e-4, cnt
    exact); two launches give identical bits; with one image and the
    Pallas window, P1's full variant equals K1 bit for bit (P1 takes only
    those)."""
    maxpp, chunk = 64, 16
    rows, start, end, kw = _forward_frame(cuda, ts, C, n_imgs, maxpp, chunk,
                                          ts + C + n_imgs)
    key = "compositor_fwd" + ("_fold" if n_imgs > 1 else "") \
        + ("_xla" if window == "xla" else "")
    before = gc.LAUNCHES[key]
    img, T, cnt = gc.compositor_fwd(rows, start, end, window=window, **kw)
    assert gc.LAUNCHES[key] == before + 1
    again = gc.compositor_fwd(rows, start, end, window=window, **kw)
    counts = {}
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, start, end,
                                                window=window, counts=counts,
                                                **kw)
    torch.cuda.synchronize()
    lead = (n_imgs,) if n_imgs > 1 else ()
    assert img.shape == lead + (C, 72, 100) and T.shape == lead + (72, 100)
    torch.testing.assert_close(img, p_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(T, p_T, atol=1e-4, rtol=1e-4)
    assert torch.equal(cnt, p_cnt)
    for a, b in zip((img, T, cnt), again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int((end - start).max()) > maxpp and kw["img_w"] % ts
    assert bool((cnt == 0).any())
    assert bool((T == 0).any())
    assert (counts["skipped_visits"] > 0) == (ts > 8 or window == "xla")
    if window == "pallas" and n_imgs == 1:
        kw.pop("n_imgs")
        full = gc.probe_fwd(rows, start, end, cnt, variant="full", **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(full, (img, T, cnt)))


@pytest.mark.parametrize("n,budget", [(4096, 32_768), (64, 512)])
def test_cumsum1d_at_the_mvp_binning_shapes(cuda, n, budget):
    """K4 at the MVP march's two scans: the prims' tile counts [K] (0 to
    64 tiles each) and the slot marks [8 K] of its pair budget (the full
    width's 4,096 prims, and the CPU test's 64), exactly."""
    g = torch.Generator(device=cuda).manual_seed(n)
    counts = torch.randint(0, 65, (n,), generator=g, device=cuda,
                           dtype=torch.int32)
    marks = torch.zeros(budget, dtype=torch.int32, device=cuda)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    marks.index_add_(0, ends.clamp(max=budget - 1).long(),
                     (ends < budget).to(torch.int32))
    for x in (counts, marks):
        before = gc.LAUNCHES["cumsum1d"]
        got = gc.cumsum1d(x)
        assert gc.LAUNCHES["cumsum1d"] == before + 1
        assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))


def _rotations(rng, K):
    """Random rotation matrices from normalized quaternions (w, x, y, z)."""
    q = rng.randn(K, 4)
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(K, 3, 3)


def test_mvp_march_on_the_card_matches_the_cpu(cuda):
    """The tiled MVP march (its binning on K4, its tiles on K8) on the card
    against the same function on the CPU, on tests/test_torch_mvp.py's scene of 12 random
    boxes at 32x32 rays with every drop occurring: rtol 1e-4 plus 1e-6 of
    the largest |value| (the deposit's atomics sum in other orders), and
    the same drop counts."""
    from goliath_torch.ops import mvp, raygen

    rng = np.random.RandomState(0)
    K, TD, H, W = 12, 4, 32, 32
    rot = _rotations(rng, K)
    pos = (rng.rand(K, 3) - 0.5) * 1.2
    scale = 2.0 + 3.0 * rng.rand(K, 3)
    tpl = rng.rand(K, 4, TD, TD, TD)
    tpl[:, 3] *= 30.0
    rp, rd, tm = raygen.compute_raydirs(
        torch.tensor([[0.0, 0.0, -3.0]]), torch.eye(3)[None],
        torch.tensor([[30.0, 30.0]]), torch.tensor([[W / 2, H / 2]]),
        raygen.make_pixelcoords(1, H, W), 1.0)
    K_cam = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    Rt = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3.0]])
    args = [rp[0], rd[0], 0.05, tm[0]] + [
        torch.from_numpy(a.astype(np.float32))
        for a in (pos, rot, scale, tpl)] + [K_cam, Rt]
    kw = dict(max_steps=100, max_prims_per_tile=4, chunk=2,
              max_prims_per_ray=2, window_steps=6, max_tiles_per_prim=2,
              pair_budget_mult=1)
    d_cpu, d_card = {}, {}
    ref = mvp.mvp_raymarch_tiled(*args, drops=d_cpu, **kw)
    before = dict(gc.LAUNCHES)
    got = mvp.mvp_raymarch_tiled(
        *[a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args],
        drops=d_card, **kw)
    assert gc.LAUNCHES["cumsum1d"] == before["cumsum1d"] + 2
    assert gc.LAUNCHES["mvp_march"] == before["mvp_march"] + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4,
                               atol=1e-6 * float(ref.abs().max()))
    assert {k: int(v) for k, v in d_card.items()} == \
        {k: int(v) for k, v in d_cpu.items()}
    assert int(d_cpu["prims_dropped"]) and int(d_cpu["window_cut_pairs"])


def _march_inputs(device, case):
    """ops/mvp.py march_inputs on the scenes of tests/test_torch_mvp.py
    (12 random boxes, 32x32 rays, step 0.05: its MARCH_CASES "exact",
    "window", "drops" and "step_cap", and "long_list") and of its warp
    test (8 boxes, 16x16 rays, step 0.1, an identity warp plus N(0,
    0.15)); "unstaged":
    300 small boxes in one 16x16 tile, step 0.005 on a grid of 1,600 steps,
    so that the tile list is longer than K8_STAGE_MAX (its rows read from
    the global table) and a block's step grids leave room for 7 warps, not
    8 (csrc/mvp_march.cu)."""
    from goliath_torch.ops import mvp, raygen

    warped = case == "warp"
    many = case == "unstaged"
    rng = np.random.RandomState(1 if warped else 3 if many else 0)
    K, TD = (8, 4) if warped else (300, 4) if many else (12, 4)
    H = W = 16 if warped or many else 32
    pos = (rng.rand(K, 3) - 0.5) * 1.2
    rot = _rotations(rng, K)
    scale = (10.0 + 10.0 * rng.rand(K, 3) if many
             else 2.0 + 3.0 * rng.rand(K, 3))
    tpl = rng.rand(K, 4, TD, TD, TD)
    tpl[:, 3] *= 30.0
    warp = None
    if warped:
        ax = np.linspace(-1, 1, TD)
        zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
        warp = torch.from_numpy((np.stack([xx, yy, zz], 0)[None].repeat(K, 0)
                                 + 0.15 * np.random.RandomState(2).randn(
                                     K, 3, TD, TD, TD)).astype(np.float32))
    rp, rd, tm = raygen.compute_raydirs(
        torch.tensor([[0.0, 0.0, -3.0]]), torch.eye(3)[None],
        torch.tensor([[30.0, 30.0]]), torch.tensor([[W / 2, H / 2]]),
        raygen.make_pixelcoords(1, H, W), 1.0)
    K_cam = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    Rt = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3.0]])
    kw = {"exact": dict(max_steps=100, max_prims_per_tile=16, chunk=8),
          "window": dict(max_steps=100, max_prims_per_tile=16, chunk=8,
                         window_steps=48),
          "drops": dict(max_steps=100, max_prims_per_tile=4, chunk=2,
                        max_prims_per_ray=2, window_steps=6,
                        max_tiles_per_prim=2, pair_budget_mult=1),
          "step_cap": dict(max_steps=12, max_prims_per_tile=16, chunk=8,
                           max_prims_per_ray=8),
          "long_list": dict(max_steps=100, max_prims_per_tile=K,
                            max_prims_per_ray=1, chunk=1),
          "warp": dict(max_steps=60, max_prims_per_tile=8, chunk=4),
          "unstaged": dict(max_steps=1600, max_prims_per_tile=K, chunk=8,
                           window_steps=96)}[case]
    step = 0.1 if warped else 0.005 if many else 0.05
    args = [rp[0], rd[0], step, tm[0]] + [
        torch.from_numpy(a.astype(np.float32))
        for a in (pos, rot, scale, tpl)] + [K_cam, Rt]
    args = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
    return mvp.march_inputs(*args, warp=None if warp is None
                            else warp.to(device), **kw)[0]


def _tie_inputs(device):
    """MarchInputs on which the accumulated alpha reaches 1 exactly: one
    axis-aligned box [-1, 1]^3 (a 4^3 template, each x column's alpha
    constant: 2, 1, 4 and 0.5), 16x16 rays along +z from z = -2 whose x and
    y are the voxel centres, steps of 0.25, no fade (fadescale 0), so each
    tap's alpha is its column's exactly and A = 1 is hit at steps 2, 4 and 1
    of the first three columns (the fourth stays at 0.875). The camera sits
    inside the box's AABB, which bins the box to every tile."""
    from goliath_torch.ops import mvp

    rng = np.random.RandomState(8)
    H = W = 16
    centres = np.asarray([-0.75, -0.25, 0.25, 0.75], np.float32)
    rp = np.zeros((H, W, 3), np.float32)
    rp[..., 0] = centres[np.arange(W) % 4][None]
    rp[..., 1] = centres[np.arange(H) % 4][:, None]
    rp[..., 2] = -2.0
    rd = np.zeros((H, W, 3), np.float32)
    rd[..., 2] = 1.0
    tminmax = np.zeros((H, W, 2), np.float32)
    tminmax[..., 1] = 10.0
    tpl = rng.rand(1, 4, 4, 4, 4).astype(np.float32)
    tpl[0, 3] = np.asarray([2.0, 1.0, 4.0, 0.5], np.float32)[None, None]
    args = [torch.from_numpy(rp), torch.from_numpy(rd), 0.25,
            torch.from_numpy(tminmax), torch.zeros(1, 3), torch.eye(3)[None],
            torch.ones(1, 3), torch.from_numpy(tpl),
            torch.tensor([[16.0, 0, 8], [0, 16.0, 8], [0, 0, 1]]),
            torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])]
    args = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
    return mvp.march_inputs(*args, max_steps=16, max_prims_per_tile=4,
                            chunk=1, max_prims_per_ray=1,
                            fadescale=0.0)[0]


@pytest.mark.parametrize("case", ["exact", "drops", "long_list", "warp",
                                  "unstaged"])
def test_k8_matches_its_plain_version(cuda, case):
    """K8 (ops/mvp_cuda.py mvp_march) against its plain version on the card
    on the same MarchInputs: rgba at rtol 1e-4 plus 1e-6 of the largest
    |value| (the plain deposit's atomics and the reductions sum in other
    orders), the in-group counts (drops and deposited taps) equal, one
    launch; with and without counts the same rgba."""
    from goliath_torch.ops import mvp_cuda as mc

    inp = _march_inputs(cuda, case)
    ref, ref_counts = mc.mvp_march_plain(inp, True)
    before = gc.LAUNCHES["mvp_march"]
    got, counts = mc.mvp_march(inp, True)
    again, none = mc.mvp_march(inp)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["mvp_march"] == before + 2 and none is None
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-6 * float(ref.abs().max()))
    assert torch.equal(got, again)
    assert {k: int(v) for k, v in counts.items()} == \
        {k: int(v) for k, v in ref_counts.items()}
    assert float(ref[:, 3].max()) > 0.3 and int(counts["taps"]) > 0
    assert (int(counts["window_cut_pairs"]) > 0) == (case == "drops")
    if case == "unstaged":
        assert int((inp.tile_end - inp.tile_start).max()) > 256


@pytest.mark.parametrize("case", ["exact", "window", "drops", "step_cap",
                                  "warp", "unstaged", "tie"])
def test_k10_matches_its_plain_version(cuda, case):
    """K10 (ops/mvp_cuda.py mvp_march_backward) against its plain version
    on the card on the same MarchInputs and a seeded N(0, 1) upstream
    gradient of the tiles' rgba: tests/test_torch_mvp.py's MARCH_CASES, the
    warp scene, the unstaged list (past K8_STAGE_MAX) and the saturation
    tie (A = 1 exactly: half the gradient); each gradient at rtol 1e-3 plus
    1e-3 of its largest |value| (float atomics in K10, the plain version's
    deposit and gathers sum in other orders); one launch a call; without
    the prims' gradients the rows' the same and the prims' zero."""
    from goliath_torch.ops import mvp_cuda as mc

    inp = _tie_inputs(cuda) if case == "tie" else _march_inputs(cuda, case)
    T, P = inp.raypos.shape[:2]
    g = torch.Generator().manual_seed(5)
    up = torch.randn(T, 4, P, generator=g).to(cuda)
    ref = mc.mvp_march_backward_plain(inp, up)
    before = gc.LAUNCHES["mvp_march_bwd"]
    got = mc.mvp_march_backward(inp, up)
    rows_only = mc.mvp_march_backward(inp, up, prim_grad=False)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["mvp_march_bwd"] == before + 2
    assert (got["wrows"] is None) == (case != "warp")
    for name in mc.MARCH_GRADS:
        if ref[name] is None:
            continue
        scale = float(ref[name].abs().max())
        assert scale > 0 and bool(torch.isfinite(got[name]).all()), name
        torch.testing.assert_close(got[name], ref[name], rtol=1e-3,
                                   atol=1e-3 * scale, msg=name)
        if name.startswith("prim"):
            assert not bool(rows_only[name].any()), name
        else:
            torch.testing.assert_close(rows_only[name], ref[name], rtol=1e-3,
                                       atol=1e-3 * scale, msg=name)
    if case == "tie":
        A = mc.mvp_march_plain(inp)[0][:, 3]
        assert bool((A == 1.0).any()) and bool((A < 1.0).any())


def test_k9_matches_its_plain_version(cuda):
    """K9 (ops/mvp_cuda.py shadow_integral) against its plain version on
    the card: seeded 16^3 and 64^3 grids, lights inside and outside the
    volume, points in and around it and one at the light; rtol 1e-5 plus
    1e-6 of the largest value (32 samples summed in other orders), one
    launch a call."""
    from goliath_torch.ops import mvp_cuda as mc

    g = torch.Generator().manual_seed(6)
    for G in (16, 64):
        density = (torch.rand(G, G, G, generator=g) * 1.5).to(cuda)
        pts = ((torch.rand(20000, 3, generator=g) - 0.5) * 2.4).to(cuda)
        for light in ([0.0, -0.2, 0.3], [0.3, 0.0, -2.5]):
            lp = torch.tensor(light, device=cuda)
            pts[-1] = lp
            ref = mc.shadow_integral_plain(density, pts, lp, 32)
            before = gc.LAUNCHES["shadow_integral"]
            got = mc.shadow_integral(density, pts, lp, 32)
            torch.cuda.synchronize()
            assert gc.LAUNCHES["shadow_integral"] == before + 1
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-6 * float(ref.abs().max()))
            assert float(got[-1]) == 0.0 and 0.05 < float(ref.mean()) < 0.95


def test_mvp_march_gradients_on_the_card_match_the_cpu(cuda):
    """The tiled march's gradients of primpos, primrot, primscale and the
    template under a seeded upstream gradient, on the scene of
    test_mvp_march_on_the_card_matches_the_cpu without its drops (tile
    lists of 16, 8 slots a ray, no window), card (K8 forward, K10
    backward) against CPU (the plain groups); on the card the binning runs
    once (K4 twice), not in the backward, and K8 and K10 once each."""
    from goliath_torch.ops import mvp, raygen

    rng = np.random.RandomState(0)
    K, TD, H, W = 12, 4, 32, 32
    rot = _rotations(rng, K)
    pos = (rng.rand(K, 3) - 0.5) * 1.2
    scale = 2.0 + 3.0 * rng.rand(K, 3)
    tpl = rng.rand(K, 4, TD, TD, TD)
    tpl[:, 3] *= 30.0
    rp, rd, tm = raygen.compute_raydirs(
        torch.tensor([[0.0, 0.0, -3.0]]), torch.eye(3)[None],
        torch.tensor([[30.0, 30.0]]), torch.tensor([[W / 2, H / 2]]),
        raygen.make_pixelcoords(1, H, W), 1.0)
    K_cam = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    Rt = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3.0]])
    up = torch.from_numpy(rng.randn(4, H, W).astype(np.float32))
    kw = dict(max_steps=100, max_prims_per_tile=16, chunk=8)
    grads = {}
    for device in ("cpu", cuda):
        leaves = [torch.from_numpy(a.astype(np.float32)).to(device)
                  .requires_grad_() for a in (pos, rot, scale, tpl)]
        before = dict(gc.LAUNCHES)
        out = mvp.mvp_raymarch_tiled(
            rp[0].to(device), rd[0].to(device), 0.05, tm[0].to(device),
            *leaves, K_cam.to(device), Rt.to(device), **kw)
        (out * up.to(device)).sum().backward()
        on_card = int(device != "cpu")
        assert {k: gc.LAUNCHES[k] - before[k] for k in before} == {
            **{k: 0 for k in before}, "cumsum1d": 2 * on_card,
            "mvp_march": on_card, "mvp_march_bwd": on_card}
        grads[str(device)] = [x.grad.cpu() for x in leaves]
    for got, ref in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-3,
                                   atol=1e-3 * float(ref.abs().max()))
        assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("model", ["hand_mvp", "hand_teacher"])
def test_mvp_small_training_step_on_the_card_matches_the_cpu(cuda, model,
                                                            monkeypatch):
    """chip_smoke.py's small training reference of the MVP hand and of the
    OLAT teacher (run_train.main at HAND_MVP_SMALL / TEACHER_SMALL, one
    step on the card and one on the CPU): on the card each march launches
    K8 once and each march under autograd K10 once."""
    import chip_smoke
    from goliath_torch.utils import render_raymarcher

    marches = {"all": 0, "grad": 0}
    orig = render_raymarcher.mvp_raymarch_tiled

    def counted(*args, **kw):
        if args[0].is_cuda:
            marches["all"] += 1
            marches["grad"] += torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)
        return orig(*args, **kw)

    monkeypatch.setattr(render_raymarcher, "mvp_raymarch_tiled", counted)
    fn = {"hand_mvp": chip_smoke.hand_mvp_small_train_reference,
          "hand_teacher": chip_smoke.teacher_small_train_reference}[model]
    before = dict(gc.LAUNCHES)
    out = fn(torch)
    assert out["losses_rel_err"] <= chip_smoke.SMALL_RTOL
    assert marches["grad"] > 0
    assert gc.LAUNCHES["mvp_march"] - before["mvp_march"] == marches["all"]
    assert gc.LAUNCHES["mvp_march_bwd"] - before["mvp_march_bwd"] == \
        marches["grad"]


def _deep_shadow_scene(seed, K, spread, TD=4):
    """Random prims of tests/test_torch_deep_shadow.py's kind, float32."""
    rng = np.random.RandomState(seed)
    rot = _rotations(rng, K)
    pos = (rng.rand(K, 3) - 0.5) * spread
    scale = 3.0 + 3.0 * rng.rand(K, 3)
    alpha = rng.rand(K, TD, TD, TD) * 8.0
    return [torch.from_numpy(a.astype(np.float32))
            for a in (pos, rot, scale, alpha)]


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_on_the_card_matches_the_cpu(cuda, padding_mode,
                                                    align_corners):
    """grid_sample_3d at coordinates reaching 0.4 outside [-1, 1], rtol
    1e-6 plus 1e-6 of the largest |value| (the same operations; the card
    may round a weight product another way only through its compiler)."""
    from goliath_torch.utils.sampling import grid_sample_3d

    g = torch.Generator().manual_seed(3)
    vol = torch.randn(2, 9, 10, 11, generator=g)
    coords = (torch.rand(64, 33, 3, generator=g) - 0.5) * 2.8
    ref = grid_sample_3d(vol, coords, padding_mode, align_corners)
    got = grid_sample_3d(vol.to(cuda), coords.to(cuda), padding_mode,
                         align_corners)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("budget", [960, 60])
def test_bin_boxes_to_cells_on_the_card_matches_the_cpu(cuda, budget):
    """The 3-D cell binning with cropped spans and invalid prims, the
    budget of 60 slots overflowing, exactly; it launches no kernel of
    the port (its prefix sum is torch.cumsum, as the JAX package's)."""
    from goliath_torch.ops.binning import bin_boxes_to_cells

    rng = np.random.RandomState(5)
    N, ncells = 120, (6, 5, 4)
    lo = np.stack([rng.randint(-2, n + 1, N) for n in ncells], -1)
    hi = lo + rng.randint(0, 7, (N, 3))
    args = (torch.from_numpy(lo.astype(np.int32)),
            torch.from_numpy(hi.astype(np.int32)),
            torch.from_numpy(rng.rand(N) > 0.2))
    ref = bin_boxes_to_cells(*args, ncells, 27, budget)
    before = dict(gc.LAUNCHES)
    got = bin_boxes_to_cells(*[a.to(cuda) for a in args], ncells, 27, budget)
    assert gc.LAUNCHES == before
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", ["all_kept", "blocks_full"])
def test_deep_shadow_on_the_card_matches_the_cpu(cuda, case):
    """splat_density_grid (rtol 1e-5 plus 1e-6 of its largest value, the
    same drop counts) and shadow_at_points on its grid (rtol 1e-5 plus
    1e-5: 32 samples summed in other orders) on the card against the CPU,
    with and without blocks over their pairs."""
    from goliath_torch.ops import mvp

    if case == "all_kept":
        scene = _deep_shadow_scene(0, 24, 1.0)
        kw = dict(grid_res=64)
    else:
        scene = _deep_shadow_scene(1, 160, 0.6)
        kw = dict(grid_res=16, block=4, max_prims_per_block=8, chunk=4)
    d_cpu, d_card = {}, {}
    ref = mvp.splat_density_grid(*scene, drops=d_cpu, **kw)
    got = mvp.splat_density_grid(*[a.to(cuda) for a in scene], drops=d_card,
                                 **kw)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))
    assert {k: int(v) for k, v in d_card.items()} == \
        {k: int(v) for k, v in d_cpu.items()}
    assert (int(d_cpu["blocks_full"]) > 0) == (case == "blocks_full")
    g = torch.Generator().manual_seed(4)
    pts = (torch.rand(5000, 3, generator=g) - 0.5) * 1.2
    for light in ([0.0, 0.0, -0.9], [0.3, -0.2, -2.5]):
        lp = torch.tensor(light)
        s_ref = mvp.shadow_at_points(ref, pts, lp, 32, point_chunk=777)
        s_got = mvp.shadow_at_points(ref.to(cuda), pts.to(cuda),
                                     lp.to(cuda), 32)
        torch.testing.assert_close(s_got.cpu(), s_ref, rtol=1e-5, atol=1e-5)
        assert 0.0 < float(s_ref.mean()) < 1.0


def test_hand_teacher_on_the_card_matches_the_cpu(cuda):
    """The teacher forward at tests/test_torch_hand_teacher.py's size (uv
    32, 48x48, 2 lights) on the card against the CPU on the jittered
    template, the same seed-0 weights: rgb, alpha, primrgb, primshadow at
    rtol 1e-3 plus 1e-3 of each output's largest |value|; on the card K4
    twice a frame, K8 once and K9 once a light, and no other kernel."""
    from goliath_torch.data.pipeline import collate
    from goliath_torch.data.synthetic import SyntheticDataset
    from goliath_torch.models.hand_teacher_mvp import AutoEncoder
    from goliath_torch.test import to_device

    ds = SyntheticDataset(n_cams=2, n_frames=2, img_h=48, img_w=48,
                          uv_size=32, n_lights=2, seed=5)
    v = ds.static_assets["template_mesh_unscaled"]
    ds.static_assets["template_mesh_unscaled"] = (
        v + np.random.RandomState(7).randn(*v.shape) * 0.5).astype(
            np.float32)
    batch = collate([ds[0]])
    outs = {}
    for device in ("cpu", cuda):
        model = AutoEncoder(
            ds.static_assets, 48, 48, n_pose_dims=6, n_embs=8,
            volradius=400.0, primsize=(8, 8, 4), learn_blur=False,
            uv_size=32, prim_scale=12.0, global_scaling=1.0,
            raymarcher={"dt": 4.0, "max_steps": 48,
                        "max_prims_per_tile": 16, "chunk": 8},
            device=device)
        gc.reset_launch_counts()
        with torch.no_grad():
            outs[str(device)] = model.apply(to_device(batch, model.device))
        launches = {k: n for k, n in gc.LAUNCHES.items() if n}
        assert launches == ({} if device == "cpu" else {
            "cumsum1d": 2, "mvp_march": 1, "shadow_integral": 2})
    for k in ("rgb", "alpha", "primrgb", "primshadow"):
        ref, got = outs["cpu"][k], outs[str(cuda)][k].cpu()
        torch.testing.assert_close(got, ref, rtol=1e-3,
                                   atol=1e-3 * float(ref.abs().max()))
        assert float(ref.abs().max()) > 0


ENVMAP_TOL = 1e-4


def _envmap_cases(rng):
    """Seeded inputs of each envmap function: {name: (fn, args)}."""
    from goliath_torch.utils import envmap as te
    from goliath_torch.utils.mipmap_sampler import mipmap_grid_sample

    def arr(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    def unit(*shape):
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return v / v.norm(dim=1, keepdim=True)

    rot = torch.from_numpy(_rotations(rng, 2).astype(np.float32))
    K = torch.zeros(2, 3, 3)
    K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = 40.0, 44.0, 1.0
    K[:, 0, 2], K[:, 1, 2] = 21.5, 13.0
    Rt = torch.cat([rot, arr(2, 3, 1) * 2.0 - 1.0], -1)
    levels = [arr(2, 3, 32 >> i, 64 >> i) for i in range(4)]
    return {
        "dir2uv": (te.dir2uv, (unit(2, 3, 9, 13), 1)),
        "rotate_envmap_mat": (te.rotate_envmap_mat, (arr(3, 32, 64),
                                                     rot[0])),
        "envmap_to_image": (lambda *a: te.envmap_to_image(40, 28, *a),
                            (arr(2, 3, 32, 64), K[:, :2, 2], K, rot)),
        "envmap_to_mirrorball": (lambda *a: te.envmap_to_mirrorball(
            24, 24, *a), (arr(2, 3, 32, 64), rot)),
        "importance_sample_sg": (lambda *a: te.importance_sample_sg(
            *a, 0.4)[0], (arr(2, 2, 9, 13), unit(2, 3, 9, 13))),
        "prefilter_envmap_sg": (lambda v, env, *d: te.prefilter_envmap_sg(
            0.4, v, env, draws=d), (unit(1, 3, 8, 16), arr(1, 3, 16, 32),
                                    arr(1, 2, 8, 16), arr(1, 2, 8, 16))),
        "mipmap_grid_sample": (lambda g, lv, *lvls: mipmap_grid_sample(
            list(lvls), g, lv), (arr(2, 5, 7, 2) * 2.2 - 1.1,
                                 arr(2, 5, 7) * 4.0 - 0.5, *levels)),
        "compose_envmap": (te.compose_envmap, (
            arr(2, 3, 28, 40), arr(2, 1, 28, 40), arr(2, 3, 32, 64) * 2.0,
            K, Rt)),
    }


@pytest.mark.parametrize("name", [
    "dir2uv", "rotate_envmap_mat", "envmap_to_image", "envmap_to_mirrorball",
    "importance_sample_sg", "prefilter_envmap_sg", "mipmap_grid_sample",
    "compose_envmap"])
def test_envmap_functions_on_the_card_match_the_cpu(cuda, name):
    """utils/envmap.py and mipmap_grid_sample on the card against the CPU,
    plain PyTorch on both: rtol 1e-4 plus 1e-4 of the largest |value|
    (the card's sin, cos, atan2, acos and erfinv are a few ulp from the
    CPU's, and a sample coordinate's ulp moves a bilinear tap; the blur's
    101x101 sums run in cuDNN's order)."""
    fn, args = _envmap_cases(np.random.RandomState(31))[name]
    ref = fn(*args)
    got = fn(*[a.to(cuda) if isinstance(a, torch.Tensor) else a
               for a in args]).cpu()
    torch.testing.assert_close(got, ref, rtol=ENVMAP_TOL,
                               atol=ENVMAP_TOL * float(ref.abs().max()))
    assert float(ref.abs().max()) > 0


def test_relight_spin_frame_on_the_card_matches_the_cpu(cuda):
    """chip_smoke.py's small relight reference: one spin frame at
    configs/rgca_synthetic.yml size, card against CPU (spec_color, the
    diffuse and specular panels, and the composite panel's mirrorball inset
    and the rest of it apart, each at rtol 1e-3 plus 1e-3 of its own largest
    entry; it raises beyond that)."""
    import chip_smoke

    errs = chip_smoke.relight_small_reference(torch)
    assert set(errs) == {"spec_color", "mirrorball", "composite_outside_ball",
                         "diffuse", "specular"}
    for err, largest in errs.values():
        assert largest > 0
        assert err <= 2 * chip_smoke.SMALL_RTOL * largest


@pytest.mark.parametrize("band", [0, 1, 2])
def test_band_kernels_match_plain(cuda, band, monkeypatch):
    """K1 and K4 at a band's shapes: the 72-row frame split in 3 bands of
    2 tile rows (the last cropped), each binned with its y offset and
    height (parallel/tile_shard.py): K1 against its plain version as
    above, K4 exactly on the band's two scans."""
    from goliath_torch.ops import binning
    from goliath_torch.parallel.tile_shard import band_geometry

    H, W, ts, maxpp, chunk = 72, 100, 16, 64, 16
    arrays = [torch.from_numpy(a).to(cuda) for a in _scene(
        np.random.RandomState(band), 400, H, W, True)]
    ntx, band_nty, band_h, budget = band_geometry(W, H, ts, 3, 400, 4, 64)
    scans, orig = [], binning.cumsum1d

    def record(x):
        scans.append(x.clone())
        return orig(x)

    monkeypatch.setattr(binning, "cumsum1d", record)
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *arrays, H, W, ts, pair_budget=budget, y_offset_px=band * band_h,
        bin_img_h=band_h)
    assert (b.num_tiles_x, b.num_tiles_y) == (ntx, band_nty) == (7, 2)
    assert len(scans) == 2 and int(b.tile_end[-1]) > 0
    for x in scans:
        assert torch.equal(gc.cumsum1d(x), gc.cumsum1d_plain(x))
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             b.sorted_prim, (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=band_h, img_w=W, tile_size=ts, ntx=ntx, nty=band_nty,
              chunk=chunk, max_pairs_per_tile=maxpp)
    img, T, cnt = gc.compositor_fwd(rows, b.tile_start, b.tile_end, **kw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, b.tile_start,
                                                b.tile_end, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, p_img, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(T, p_T, atol=1e-4, rtol=1e-4)
    assert torch.equal(cnt, p_cnt)


@pytest.mark.parametrize("axis_kind", ["tile", "slab"])
def test_sharded_renders_on_the_card_match_the_cpu(cuda, axis_kind):
    """The band render (3 bands) and the slab render (3 slabs) of a small
    batch, outputs and gradients, on the card (K1, K4, K2, K3) against the
    CPU (plain versions): rtol 1e-3 with atol 1e-3 of each entry's
    largest; the kernels launched once a band or slab and sample."""
    from goliath_torch.parallel.sharding import Mesh
    from goliath_torch.parallel.tile_shard import (
        render_prim_sharded,
        render_tile_sharded,
    )

    H, W = 72, 100
    arrays = [torch.from_numpy(np.stack(pair)) for pair in zip(
        _scene(np.random.RandomState(9), 300, H, W, False),
        _scene(np.random.RandomState(10), 300, H, W, False))]
    fn = render_tile_sharded if axis_kind == "tile" else render_prim_sharded
    kw = dict(tile_size=16, max_pairs_per_tile=128, chunk=32,
              pair_budget_mult=4, use_pallas=True)

    def run(dev):
        ins = [t.to(dev) for t in arrays]
        leaves = [ins[i].clone().requires_grad_(True) for i in (2, 5, 6)]
        ins[2], ins[5], ins[6] = leaves
        out = fn(Mesh([dev] * 3, ("x",)), "x", W, H, *ins, **kw)
        ((out["render"] ** 2).mean() + out["alpha"].mean()).backward()
        return ({k: v.detach().cpu() for k, v in out.items()},
                [t.grad.cpu() for t in leaves])

    gc.reset_launch_counts()
    got, g_got = run(cuda)
    torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    ref, g_ref = run(torch.device("cpu"))
    assert launches["compositor_fwd"] == launches["pair_grads"] == 6
    assert launches["cumsum_cols"] == 6 and launches["cumsum1d"] == 12
    for k in ref:
        scale = float(ref[k].abs().max())
        torch.testing.assert_close(got[k], ref[k], rtol=1e-3,
                                   atol=1e-3 * scale, msg=lambda m: f"{k}: {m}")
    for g, r in zip(g_got, g_ref):
        scale = float(r.abs().max())
        assert scale > 0
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * scale)


def test_sharded_step_on_the_card_matches_the_cpu(cuda):
    """One sharded RGCA step of the dry run (48x48, uv 32, batch 4 on 4
    shards) on the card against the CPU, from the same parameters and
    draws: the losses at rtol 1e-3, every gradient at rtol 1e-3 with atol
    1e-3 of its largest entry or else within 4 times its spread beyond
    that. The spread of a gradient is the larger of its largest move on the
    card when every parameter is scaled by 1 + 1e-7 N(0, 1) (seeds 1-3)
    and the unsharded step's own distance between the card and the CPU:
    sharding adds nothing to what the card and the CPU differ by."""
    from goliath_torch import train as train_lib
    from goliath_torch.parallel import make_sharded_train_step
    from goliath_torch.parallel.sharding import Mesh
    from goliath_torch.scripts import dryrun_multichip as dr

    def run(dev, seed=None, shards=4):
        ds, model, batch = dr.build_rgca(48, 32, 2, 4, dev)
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in model.module.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(
                        p.shape, generator=gen).to(p.device))
        loss_fn, opt = dr.family_loss_and_optimizer("rgca", ds, model)
        step = (make_sharded_train_step(model, loss_fn, opt,
                                        Mesh([dev] * shards, ("data",)))
                if shards else train_lib.make_train_step(model, loss_fn, opt))
        total, ldict = step({k: torch.as_tensor(v).to(dev)
                             for k, v in batch.items()}, 0)
        return ({k: float(v) for k, v in ldict.items()},
                {n: p.grad.cpu() for n, p in model.module.named_parameters()})

    got, g_got = run(cuda)
    ref, g_ref = run(torch.device("cpu"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-3), k
    spread, need = {}, []
    for n, r in g_ref.items():
        scale = float(r.abs().max())
        diff = (g_got[n] - r).abs()
        usual = 1e-3 * r.abs() + 1e-3 * scale
        if bool((diff <= usual).all()):
            continue
        if not spread:
            card1 = run(cuda, shards=0)[1]
            cpu1 = run(torch.device("cpu"), shards=0)[1]
            spread = {k: float((card1[k] - cpu1[k]).abs().max())
                      for k in g_got}
            for seed in (1, 2, 3):
                for k, g in run(cuda, seed)[1].items():
                    spread[k] = max(spread[k],
                                    float((g - g_got[k]).abs().max()))
        need.append((n, float(diff.max()) / scale, spread[n] / scale))
        assert bool((diff <= usual + 4.0 * spread[n]).all()), need[-1]
    print(f"gradients that need their spread: {need}")


def _library_small_cases():
    """The modules of chip_smoke.library_cases at small widths."""
    from goliath_torch.nn import blocks, color_cal, layers, shadow, unet

    B, C = 2, 8
    mean = np.random.RandomState(9).rand(1, 64, 64).astype(np.float32)
    idx = np.asarray([1, 0], np.int32)   # sample 0 not the identity camera
    cams = ["400870", "410001", "401031"]
    return {
        "pose_cond": (lambda g: shadow.ShadowUNet_PoseCond(
            128, mean, 32, n_dims=4, n_pose_dims=6, n_pose_enc_dims=8,
            generator=g), [(B, 1, 64, 64), (B, 6)], []),
        "dist_map": (lambda g: shadow.DistMapShadowUNet(
            128, 32, 3, n_dims=4, biases=False, generator=g),
            [(B, 3, 64, 64)], []),
        "floor": (lambda g: shadow.FloorShadowDecoder(512, generator=g),
                  [(1, 1, 256, 256)], []),
        "unet_w": (lambda g: unet.UNetW(4, 3, 4, generator=g),
                   [(B, 4, 64, 96)], []),
        "unet_wb_concat": (lambda g: unet.UNetWBConcat(4, 3, 64, 4,
                                                       generator=g),
                           [(B, 4, 64, 64)], []),
        "upscale_net": (lambda g: blocks.UpscaleNet(3, 3, 4, 32, generator=g),
                        [(B, 3, 32, 32)], []),
        **{f"cal_{v}": (lambda g, v=v: color_cal.make_cal(
            v, cameras=cams if v != "v6" else cams[::2],
            identity_camera="400870"), [(B, 3, 20, 12)], [idx])
           for v in ("identity", "v3", "v5", "v6")},
        "layers": (lambda g: layers.Sequential([
            layers.ConvTranspose2dWN(C, C, 4, 2, 1, generator=g),
            layers.LeakyReLU(),
            layers.UpConv2dWN(C, C, 3, 1, 1, generator=g),
            layers.Conv2dELR(C, C, 3, 2, 1, lr_mul=0.5, generator=g),
            layers.Downsample(),
            *layers.make_conv(C, C, 3, 1, 1, ub=(16, 16), generator=g)]),
            [(B, C, 16, 16)], []),
        "linear_elr": (lambda g: layers.LinearELR(C, 5, generator=g),
                       [(B, 40, C)], []),
        "concat_pyramid": (lambda g: layers.ConcatPyramid([
            layers.ConvTranspose2dWN(C + 3, C, 4, 2, 1, generator=g),
            layers.LeakyReLU(),
            layers.ConvTranspose2dWN(C + 3, C, 4, 2, 1, generator=g)],
            n_concat_in=3, transposed=True), [(B, C, 8, 8), (B, 3, 32, 32)],
            []),
    }


@pytest.mark.parametrize("name", sorted(_library_small_cases()))
def test_library_module_on_the_card_matches_the_cpu(cuda, name):
    """chip_smoke.py's library check (lib_card_vs_cpu) at small widths."""
    import chip_smoke

    make, shapes, ints = _library_small_cases()[name]
    kinks = not name.startswith(("cal_", "linear_elr"))
    res = chip_smoke.lib_card_vs_cpu(torch, make, shapes, ints, kinks)
    res.pop("step")
    assert res["holds"], res


def test_render_example_on_the_card_matches_the_cpu(cuda, tmp_path):
    """render() on configs/rgca_synthetic.yml (use_pallas unset: K1 in the
    XLA window), on the card and on the CPU: K1 4 and K4 8 launches, the
    grids within 1 LSB of uint8."""
    from pathlib import Path

    from goliath_torch.config import load_config
    from goliath_torch.examples import render_example as rex

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                          / "rgca_synthetic.yml"))
    gc.reset_launch_counts()
    card = rex.render(cfg, out_path=str(tmp_path / "card.png"),
                      device="cuda")["grid"]
    torch.cuda.synchronize()
    assert gc.LAUNCHES["compositor_fwd_xla"] == 4
    assert gc.LAUNCHES["cumsum1d"] == 8
    host = rex.render(cfg, out_path=str(tmp_path / "cpu.png"),
                      device="cpu")["grid"]
    assert card.shape == host.shape == (64, 256, 3)
    assert np.abs(card.astype(np.int16) - host.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("name", ["rgca", "hand_mvp", "hand_teacher",
                                  "urhand", "mesh_vae"])
def test_cross_device_step_matches_the_card(cuda, name):
    """The dry run's step of ``name`` at batch 2 on a "data" mesh of
    (cuda:0, cpu): the model on the card, its replica on the host, held
    against the unsharded step on the card (chip_smoke.cross_device_family:
    the losses, the gradients, the parameters after the update, the
    replica after the step and the card's launches)."""
    import chip_smoke

    have, rep = chip_smoke.cross_device_family(gc, torch, name,
                                               ["cuda:0", "cpu"])
    assert list(have) == [0]
    assert rep["loss_rel"] <= chip_smoke.SMALL_RTOL


@pytest.mark.parametrize("which", [0, 1])
def test_cross_device_band_step_matches_the_card(cuda, which):
    """The dry run's RGCA step on a ("data", "tile") mesh of the card and
    the host (chip_smoke.CROSS_ROWS[which]), the model's render banded over
    each data shard's row, against the unsharded step on the card
    (chip_smoke.cross_device_family with rows)."""
    import chip_smoke

    have, rep = chip_smoke.cross_device_family(
        gc, torch, "rgca", None, rows=chip_smoke.CROSS_ROWS[which])
    assert list(have) == [0]
    assert rep["loss_rel"] <= chip_smoke.SMALL_RTOL


def test_cross_device_renders_match_the_card(cuda):
    """The dry run's tile axis in 2 bands and its scene in 2 slabs over
    (cuda:0, cpu) against the unsharded renders on the card
    (chip_smoke.cross_device_renders), the card's launches exact."""
    import chip_smoke

    counts = chip_smoke.cross_device_renders(gc, torch, ["cuda:0", "cpu"])
    assert counts["bands"][0]["compositor_fwd_xla"] == 2


def test_two_card_step_and_renders_match_one_card(cuda):
    """The same over two cards (cuda:0, cuda:1): the RGCA step against the
    unsharded step on cuda:0, the bands and the slabs against the renders
    on cuda:0; each card launching its shard's kernels."""
    import chip_smoke

    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, {torch.cuda.device_count()} visible")
    have, _ = chip_smoke.cross_device_family(gc, torch, "rgca",
                                             ["cuda:0", "cuda:1"])
    assert sorted(have) == [0, 1]
    counts = chip_smoke.cross_device_renders(gc, torch, ["cuda:0", "cuda:1"])
    assert sorted(counts["bands"]) == [0, 1]
