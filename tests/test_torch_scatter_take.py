"""Part of tests/test_torch_scatter.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.ops import scatter as ts
from goliath_tpu.ops import scatter as js

from tests.test_torch_scatter import ATOL, RTOL

torch.set_num_threads(1)


def test_take_cols_forward_and_backward_match_jax():
    rng = np.random.RandomState(2)
    table = rng.standard_normal((4, 50)).astype(np.float32)
    idx = rng.randint(0, 50, (6, 9)).astype(np.int32)
    w = rng.standard_normal((4, 6, 9)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda t: (js.take_cols(t, jnp.asarray(idx)) * w).sum())(
            jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = ts.take_cols(t, torch.from_numpy(idx))
    assert out.shape == (4, 6, 9)
    assert torch.equal(out, t[:, torch.from_numpy(idx).long()])
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose((out * torch.from_numpy(w)).sum().item(),
                               float(ref), rtol=1e-5)
