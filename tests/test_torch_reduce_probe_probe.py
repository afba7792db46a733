"""Part of tests/test_torch_reduce_probe.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import pytest
import torch

from goliath_torch.ops import gsplat_cuda
from goliath_torch.scripts import probe_kernel

from tests.test_torch_reduce_probe import _frame

torch.set_num_threads(1)


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
