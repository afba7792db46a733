"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import hdr as th, sampling as ts
from goliath_tpu.utils import hdr as jh, sampling as js

from tests.test_torch_envmap import (
    EXACT_TOL,
    _decode,
    _hdr_header,
    _rle_channel,
    close,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("rle", [False, True])
def test_read_hdr_matches_jax_and_the_bytes(tmp_path, rle):
    rng = np.random.default_rng(3 + rle)
    H, W = 5, 37
    rgbe = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (H, W))
    rgbe[1, 3:20] = rgbe[1, 3]          # runs for the RLE coder
    rgbe[2, :, 3] = 0                   # e == 0 decodes to 0
    rgbe[:, 0, 0] = np.where(rgbe[:, 0, 0] == 2, 3, rgbe[:, 0, 0])
    body = bytearray()
    for y in range(H):
        if rle:
            body += bytes([2, 2, W >> 8, W & 255])
            for c in range(4):
                body += _rle_channel(rgbe[y, :, c].tolist())
        else:
            body += rgbe[y].tobytes()
    path = tmp_path / ("rle.hdr" if rle else "flat.hdr")
    path.write_bytes(_hdr_header(H, W) + bytes(body))
    got = th.load_envmap(str(path))
    ref = jh.load_envmap(str(path))
    # float64, as the JAX reader's (its ldexp scale is float64), though
    # the module says float32; EnvSpinDecorator casts it
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _decode(rgbe))


def test_read_hdr_refuses_other_files(tmp_path):
    path = tmp_path / "x.hdr"
    path.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        th.load_envmap(str(path))


def test_avg_pool2d_matches_jax():
    x = np.random.default_rng(7).random((2, 3, 8, 12)).astype(np.float32)
    close(ts.avg_pool2d(torch.from_numpy(x), 2),
          js.avg_pool2d(jnp.asarray(x), 2), EXACT_TOL, EXACT_TOL)
