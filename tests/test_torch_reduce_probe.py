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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda
from goliath_tpu.ops import gsplat_pallas

from test_torch_gsplat import _scene

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)


@pytest.mark.parametrize("f", [1, 3, 10, 16])
@pytest.mark.parametrize("m", ([1, 63, 1000])[0:1])
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


_XLA_CASES = {
    # tiles over max_pairs_per_tile, translucent
    "overflow": dict(opaque=False, N=150, kw=dict(
        tile_size=16, max_pairs_per_tile=64, chunk=16, pair_budget_mult=4)),
    # opaque: T falls to ~3e-14 in some pixels (no early-out in this window)
    "opaque": dict(opaque=True, N=400, kw=dict(
        tile_size=16, max_pairs_per_tile=256, chunk=32, pair_budget_mult=4)),
}
