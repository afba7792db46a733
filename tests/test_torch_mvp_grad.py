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


@pytest.mark.parametrize("case", (sorted(CASES))[0:4])
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
