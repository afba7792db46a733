"""Part of tests/test_torch_mvp_grad.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import T
from tests.test_torch_mvp_grad import (
    CASES,
    GRAD_OF_SCALE,
    GRAD_RTOL,
    _inputs,
    _port_grads,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", (sorted(CASES))[4:5])
def test_tiled_march_gradients_match_jax(case):
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, up = _inputs(case)
    names = [k for k, v in diff.items() if v is not None]

    def f(*args):
        d = dict(zip(names, args))
        out = jm.mvp_raymarch_tiled(
            jnp.asarray(rp), jnp.asarray(rd), stepsize, jnp.asarray(tminmax),
            d["primpos"], d["primrot"], d["primscale"], d["template"],
            jnp.asarray(K_cam), jnp.asarray(Rt), warp=d.get("warp"), **kw)
        return jnp.sum(out * up), out

    (_, ref_out), ref = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(diff[k]) for k in names))
    out, got = _port_grads(case)
    assert float(np.asarray(ref_out)[3].max()) > 0.3   # a visible scene
    assert set(got) == set(names)
    for name, r in zip(names, ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0 and np.isfinite(r).all(), name
        np.testing.assert_allclose(got[name].numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_OF_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("case", ["drops", "step_cap"])
def test_recompute_equals_the_plain_march(case, monkeypatch):
    """With GROUP_TAPS low enough that the tiles form several groups, the
    march whose groups are recomputed in the backward gives the output and
    the gradients of the march that keeps every group's temporaries, bit
    for bit."""
    kw, _, _, _, _ = _inputs(case)
    rc = min(kw["chunk"], kw.get("max_prims_per_ray", 16),
             kw["max_prims_per_tile"])
    sp = min(kw.get("window_steps") or kw["max_steps"], kw["max_steps"])
    monkeypatch.setattr(tm, "GROUP_TAPS", rc * sp * 256)   # one tile a group
    calls = []
    orig = tm.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(kwargs)
        return orig(fn, *args, **kwargs)

    monkeypatch.setattr(tm, "checkpoint", counted)
    out, grads = _port_grads(case)
    assert len(calls) >= 2 and all(c == {"use_reentrant": False}
                                   for c in calls)
    monkeypatch.setattr(tm, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    plain_out, plain = _port_grads(case)
    assert torch.equal(out, plain_out)
    assert set(grads) == set(plain)
    for name, g in grads.items():
        assert torch.equal(g, plain[name]), name


def test_saturation_ties_take_half_the_gradient():
    """``saturate`` through ``accumulate_additive`` against the JAX
    package's, with rays whose accumulated alpha reaches 1 exactly (steps
    of 0.25) and goes past it: the values and the gradients of alpha and
    rgb, where jnp.minimum gives half the gradient at the tie."""
    rng = np.random.RandomState(4)
    alpha = np.full((3, 8), 2.5, np.float32)      # alpha * 0.1 = 0.25
    alpha[1, 2:] = rng.rand(6).astype(np.float32) # under the tie
    alpha[2] = rng.rand(8).astype(np.float32) * 6
    rgb = rng.rand(3, 8, 3).astype(np.float32)
    up = rng.randn(3, 4).astype(np.float32)

    def jf(a, c):
        out = jax.vmap(lambda r, x: jm.accumulate_additive(r, x, 0.1))(c, a)
        return jnp.sum(out * up), out

    (_, ref), (ga, gc) = jax.value_and_grad(jf, argnums=(0, 1),
                                            has_aux=True)(alpha, rgb)
    a, c = T(alpha).requires_grad_(), T(rgb).requires_grad_()
    out = tm.accumulate_additive(c, a, 0.1)
    (out * T(up)).sum().backward()
    A, _ = tm.saturate(T(alpha), 0.1)
    assert float(A[0, 3]) == 1.0                    # the tie
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), ga, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), gc, rtol=1e-5, atol=1e-6)
    # a clamp would give the tie its whole gradient: the data hold one
    x = T(alpha).requires_grad_()
    A = torch.cumsum(x * 0.1, -1).clamp(max=1.0)
    contrib = torch.diff(A, dim=-1, prepend=torch.zeros_like(A[..., :1]))
    clamped = torch.cat([(T(rgb) * contrib[..., None]).sum(-2),
                         A[..., -1:]], -1)
    (clamped * T(up)).sum().backward()
    assert not np.allclose(x.grad.numpy()[0], ga[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy()[1:], ga[1:], rtol=1e-5,
                               atol=1e-6)
