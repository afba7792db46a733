"""``FloorShadowDecoder`` (nn/shadow.py, a fixed 512-resolution UNet) at
batch 1 against the JAX package on the CPU, with
tests/test_torch_library.py's weight carry, gradients and tolerance: from
an AO map at 256^2 (resized to uv_size with align_corners=True) and from
one at uv_size (no resize). Outputs at tests/test_torch_library.py's
tolerance; gradients at 1e-3 (rtol, and atol of the largest entry): they
are float32 sums over up to 512^2 pixels x 64 channels taken in other
orders, and the weight norm's projection of down1's gradient cancels. From
the 256^2 map, both packages' float32 gradient of down1.weight_v is 6e-3 of
its largest entry from a float64 one, and 3.4e-4 from each other. A
share GRAD_OUTLIERS of each gradient's entries may lie beyond that (each
within half its largest entry): a leaky ReLU whose input sits within
rounding of 0 takes slope 1 in one package and 0.2 in the other, and every
gradient behind it changes over its receptive field. From the 256^2 map
the JAX gradient of down1's untied bias differs so from a float64 one in
1,282 of its 4,194,304 entries (up to 0.35 of the largest), the port's in
1.
"""

import numpy as np
import pytest
import torch

from goliath_torch.nn import shadow as tsh
from goliath_tpu.nn import shadow as jsh
from tests.test_torch_library import _gen, hold

torch.set_num_threads(1)

GRAD_TOL = 1e-3
GRAD_OUTLIERS = 1e-3


@pytest.mark.parametrize("ao_size", [256, 512])
def test_floor_shadow_decoder_matches_jax(ao_size):
    ao = np.random.RandomState(ao_size).rand(
        1, 1, ao_size, ao_size).astype(np.float32)
    got = hold(jsh.FloorShadowDecoder(uv_size=512),
               tsh.FloorShadowDecoder(uv_size=512, generator=_gen()), [ao],
               grad_tol=GRAD_TOL, grad_outliers=GRAD_OUTLIERS)
    s = got["shadow_map"].detach()
    assert s.shape == (1, 1, 512, 512)
    assert bool(((s >= 0) & (s <= 1)).all())
