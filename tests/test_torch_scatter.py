"""Parity of the port's sort-based scatter-add (ops/scatter.py, K3's second
call site) with the JAX package on the CPU, both branches, and ``take_cols``
with its hand-written backward.

Tolerance: rtol 1e-5 / atol 1e-4. The sorted branch takes each target's sum
as a difference of float32 prefix sums over all updates (running sums up to
~50 here), the other branch adds directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_tpu.ops import scatter as js
from goliath_torch.ops import scatter as ts

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _case(seed, P=700, C=3, N=90):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-5, N + 5, P).astype(np.int32)   # some out of range
    vals = rng.standard_normal((C, P)).astype(np.float32)
    return idx, vals, N


@pytest.mark.parametrize("force_sorted", [False, True])
def test_indexed_add_cf_matches_jax(force_sorted):
    idx, vals, N = _case(0)
    ref = js.indexed_add_cf(jnp.asarray(idx), jnp.asarray(vals), N,
                            _force_sorted=force_sorted)
    got = ts.indexed_add_cf(torch.from_numpy(idx), torch.from_numpy(vals), N,
                            _force_sorted=force_sorted)
    assert got.shape == (3, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # against the definition, out-of-range updates dropped
    ok = (idx >= 0) & (idx < N)
    want = np.zeros((3, N), np.float64)
    np.add.at(want.T, idx[ok], vals.T[ok].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("force_sorted", [False, True])
def test_indexed_add_row_major_and_empty_targets(force_sorted):
    idx, vals, N = _case(1, P=60, C=2, N=200)   # most targets take nothing
    ref = js.indexed_add(jnp.asarray(idx), jnp.asarray(vals.T), N,
                         _force_sorted=force_sorted)
    got = ts.indexed_add(torch.from_numpy(idx), torch.from_numpy(vals.T), N,
                         _force_sorted=force_sorted)
    assert got.shape == (N, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    untouched = np.setdiff1d(np.arange(N), idx)
    assert len(untouched) > 100 and not got[untouched].any()


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
