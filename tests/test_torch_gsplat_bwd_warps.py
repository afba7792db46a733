"""Part of tests/test_torch_gsplat_bwd.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch
from test_torch_gsplat import _scene

from goliath_torch.ops import gsplat as tg, gsplat_cuda

from tests.test_torch_gsplat_bwd import _brute_force_warp_visits

torch.set_num_threads(1)


@pytest.mark.parametrize("ts", [8, 16])
def test_pair_grads_plain_counts_warp_visits(ts):
    """The warp-visit and shuffle counts of ``pair_grads_plain`` against a
    brute-force loop, on a frame with an overflowing tile (the Pallas
    window cuts it) and partial edge tiles (76 = 4 * 16 + 12 = 9 * 8 + 4
    columns)."""
    rng = np.random.RandomState(7)
    H, W, maxpp, chunk = 40, 76, 64, 16
    K, Rt, *prims = _scene(rng, 1, 150, H, W, True)
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *(torch.from_numpy(a[0]) for a in (K, Rt, *prims)), H, W, ts,
        pair_budget=1200)
    ntx, nty = -(-W // ts), -(-H // ts)
    rows = gsplat_cuda.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                                      b.sorted_prim,
                                      (maxpp // chunk + 1) * chunk)
    img, T, cnt = gsplat_cuda.compositor_fwd_plain(
        rows, b.tile_start, b.tile_end, H, W, ts, ntx, nty, chunk, maxpp)
    assert int((b.tile_end - b.tile_start).max()) > maxpp
    assert W % ts
    C = chan.shape[1]
    g = np.random.RandomState(8)
    counts = {}
    gsplat_cuda.pair_grads_plain(
        rows, b.tile_start, b.tile_end, cnt,
        torch.from_numpy(g.randn(C, H, W).astype(np.float32)),
        torch.from_numpy(g.randn(H, W).astype(np.float32)), T, ts, ntx, nty,
        chunk, 1200, counts=counts)
    kept, visits = _brute_force_warp_visits(
        rows, b.tile_start, b.tile_end, cnt, H, W, ts, chunk, C)
    assert int(counts["kept"]) == kept > 0
    for d in gsplat_cuda.K2_WARP_MAPS:
        assert int(counts["warp_visits"][d]) == visits[d] > 0, d
        assert int(counts["shuffles"][d]) == visits[d] * (
            5 * (6 + C) if d == "row32" else 32), d
    # the current design's warps hold 2-4x the pixels: fewer visits
    assert visits["regions"] < visits["row32"]


def test_fold_grads_check_capture_and_shares(monkeypatch):
    """fold_grads_check keeps the batch-folded pair_grads calls only, with
    GOLIATH_GSPLAT_FOLD=1 inside its block and the variable and the function
    restored after; its shares (chip_smoke's tolerance) are 0 for equal
    gradients and over 1, in that column alone, for one entry moved past
    the tolerance."""
    import importlib.util
    import os

    from goliath_torch.scripts import fold_grads_check as fgc

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", fgc.ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.delenv("GOLIATH_GSPLAT_FOLD", raising=False)
    seen, store = [], []

    def pair_grads(*args):
        seen.append(args)
        return args[-2]

    monkeypatch.setattr(gsplat_cuda, "pair_grads", pair_grads)
    with fgc.CaptureFold(gsplat_cuda, store):
        assert os.environ["GOLIATH_GSPLAT_FOLD"] == "1"
        assert gsplat_cuda.pair_grads(torch.ones(2), 3, 4, "pallas") == 4
        assert gsplat_cuda.pair_grads(torch.ones(2), 3, 1, "xla") == 1
    assert "GOLIATH_GSPLAT_FOLD" not in os.environ
    assert gsplat_cuda.pair_grads is pair_grads
    assert len(seen) == 2 and len(store) == 1 and store[0][-2:] == (4, "pallas")

    g = torch.Generator().manual_seed(0)
    ref = torch.randn(200, 16, generator=g)
    ref[:, 10:] = 0
    ref[150:] = 0                          # rows without a gradient
    assert all(s == 0 and n == 0
               for s, n in fgc.column_shares(cs, ref.clone(), ref, 10))
    got = ref.clone()
    got[7, 3] += 1.0
    shares = fgc.column_shares(cs, got, ref, 10)
    assert shares[3][0] > 1 and shares[3][1] == 1
    assert all(s == 0 and n == 0
               for k, (s, n) in enumerate(shares) if k != 3)
