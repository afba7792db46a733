"""Part of tests/test_torch_reduce_probe.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gsplat import _scene

from goliath_torch.ops import gsplat as tg
from goliath_torch.scripts import profile_reduce
from goliath_tpu.ops import gsplat as jg

from tests.test_torch_reduce_probe import _XLA_CASES

torch.set_num_threads(1)


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
