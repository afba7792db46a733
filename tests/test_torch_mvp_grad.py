"""Gradients of the port's tile-culled MVP march (goliath_torch/ops/mvp.py)
against the JAX package's on the CPU, on tests/test_torch_mvp.py's scenes:
``jax.grad`` of the jitted JAX ``mvp_raymarch_tiled`` and autograd through
the port's (each tile group recomputed in the backward) with respect to
the template, primpos, primrot, primscale and the warp field, in each of
``MARCH_CASES`` (every drop of the march occurring in ``drops`` and
``step_cap``) and on the warp test's scene; the recomputed march equal to
the march without recompute, bit for bit, with several groups; the
saturation's tie at A = 1; and the refusal of ``drops`` under autograd.

Tolerance: rtol 1e-4 plus 1e-4 of each gradient's largest |reference|
entry (float32 sums of taps taken in other orders; measured at most ~1e-5
of the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import MARCH_CASES, T, _rays, _scene

torch.set_num_threads(1)

GRAD_RTOL = GRAD_OF_SCALE = 1e-4
NAMES = ("primpos", "primrot", "primscale", "template", "warp")


def _warp(K, TD, seed=2):
    """An identity warp field plus N(0, 0.15) (tests/test_torch_mvp.py)."""
    ax = np.linspace(-1, 1, TD, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.stack([xx, yy, zz], 0)[None].repeat(K, 0) + 0.15
            * np.random.RandomState(seed).randn(K, 3, TD, TD, TD)
            .astype(np.float32))


# MARCH_CASES on the scene of seed 0 (32x32 rays, step 0.05), and the
# warp test's scene (seed 1, 8 prims, 16x16 rays, step 0.1)
CASES = {name: (kw, _scene(0), _rays(), 0.05, None)
         for name, (kw, _) in MARCH_CASES.items()}
CASES["warp"] = (dict(max_steps=60, max_prims_per_tile=8, chunk=4),
                 _scene(1, K=8), _rays(16, 16), 0.1, _warp(8, 4))


def _inputs(case):
    kw, scene, rays, stepsize, warp = CASES[case]
    rp, rd, tminmax, K_cam, Rt = rays
    up = np.random.RandomState(9).randn(4, *rp.shape[:2]).astype(np.float32)
    return kw, dict(zip(NAMES, (*scene, warp))), (rp, rd, tminmax, K_cam,
                                                  Rt), stepsize, up


def _port_grads(case):
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, up = _inputs(case)
    leaves = {k: T(v).requires_grad_() for k, v in diff.items()
              if v is not None}
    out = tm.mvp_raymarch_tiled(
        T(rp), T(rd), stepsize, T(tminmax), leaves["primpos"],
        leaves["primrot"], leaves["primscale"], leaves["template"], T(K_cam),
        T(Rt), warp=leaves.get("warp"), **kw)
    (out * T(up)).sum().backward()
    return out.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("case", sorted(CASES))
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


def test_march_refuses_drops_under_autograd():
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, _ = _inputs("exact")
    args = [T(rp), T(rd), stepsize, T(tminmax),
            T(diff["primpos"]).requires_grad_(), T(diff["primrot"]),
            T(diff["primscale"]), T(diff["template"]), T(K_cam), T(Rt)]
    with pytest.raises(ValueError, match="drops"):
        tm.mvp_raymarch_tiled(*args, drops={}, **kw)
    with torch.no_grad():
        drops = {}
        tm.mvp_raymarch_tiled(*args, drops=drops, **kw)
    assert int(drops["tiles_marched"]) == 4
