"""The march's composite (goliath_torch/ops/mvp.py ``composite``: the step
grid's mean colour and saturation, computed in float64 and cast back), and
where its gradient departs from ``jax.grad``.

The composite's forward against the JAX package's float32 expressions on
rays with steps of tiny alpha, empty steps, dead steps, saturation and a
tie at A = 1; its backward against autograd of the same expressions in
float64, and on every step below saturation the gradient of the step's
rgb sums equal to the upstream gradient times stepsize, the function's
exact derivative (contrib / alpha = stepsize there). Autograd of the
float32 expressions misses that derivative at the tiny steps: contrib /
alpha there is 0 or a multiple of stepsize.

The departure from ``jax.grad``, whose march composites in float32: on
tests/test_torch_mvp.py's scene of seed 0 with every other prim's alpha
scaled by 1e-9, so that the steps through those prims behind the others
have alpha * stepsize below an ulp of A, the port's float32 march holds
its own march in float64 (every input float64) at
tests/test_torch_mvp_grad.py's tolerance, and so does ``jax.grad`` on the
prims' parameters and the opaque prims' template; on the faint prims'
template ``jax.grad`` is off the float64 march by more than 1e-3 of the
template gradient's largest entry (2.1e-3 measured; the port's float32
march 1.8e-6).

Tolerance: rtol 1e-4 plus 1e-5 of each gradient's largest |value| for the
composite (float32 sums over 24 steps against float64), 1e-6 of the
largest for its forward against the float32 expressions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import MARCH_CASES, _rays, _scene
from tests.test_torch_mvp_grad import GRAD_OF_SCALE, GRAD_RTOL

torch.set_num_threads(1)

STEP = 0.25


def _grid():
    """acc [2, 6, 4, 24] (rgb * a sums, then a), live_s [2, 6, 24] and an
    upstream gradient [2, 4, 6]."""
    rng = np.random.RandomState(3)
    g, P, S = 2, 6, 24
    a = (rng.rand(g, P, S) * 0.4).astype(np.float32)
    a[:, :, 5] = 3e-9          # alpha * stepsize far below an ulp of A
    a[:, :, 6] = 1e-7
    a[:, :, 7] = 0.0
    a[0, 0, :3] = 2.0          # A = 0.5, 1.0 exactly: the tie
    a[1, 1] *= 0.1             # stays below saturation
    rgb = (rng.rand(g, P, 3, S) * 20.0).astype(np.float32) * a[:, :, None]
    acc = np.concatenate([rgb, a[:, :, None]], 2)
    live = np.ones((g, P, S), bool)
    live[:, 2, 20:] = False
    up = rng.randn(g, 4, P).astype(np.float32)
    return torch.from_numpy(acc), torch.from_numpy(live), torch.from_numpy(up)


def _expressions(acc, live_s):
    """The JAX package's march group's composite in the dtype of ``acc``,
    autograd's to differentiate."""
    alpha = acc[:, :, 3] * live_s
    safe = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    A_clip, contrib = tm.saturate(alpha, STEP)
    rgb_out = (acc[:, :, :3] / safe[:, :, None] * contrib[:, :, None]).sum(-1)
    return torch.cat([rgb_out, A_clip[..., -1:]], -1).transpose(1, 2)


def test_composite_forward_is_the_plain_expressions():
    acc, live, _ = _grid()
    got = tm.composite(acc, live, STEP)
    ref = _expressions(acc, live)
    assert got.dtype == torch.float32
    assert torch.equal(got, _expressions(acc.double(), live).float())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    A = torch.cumsum(acc[:, :, 3] * live * STEP, -1)
    assert float(A[0, 0, 1]) == 1.0 and bool((A < 1).any())


def test_composite_backward_is_the_float64_derivative():
    acc, live, up = _grid()
    x = acc.clone().requires_grad_()
    (tm.composite(x, live, STEP) * up).sum().backward()
    x64 = acc.double().requires_grad_()
    (_expressions(x64, live) * up.double()).sum().backward()
    ref = x64.grad.numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * scale)
    assert float(np.abs(ref[..., :3, 0]).max()) > 0   # the tie's step
    # below saturation d rgb_out / d acc_rgb[s] = contrib / alpha = stepsize
    alpha = acc[:, :, 3] * live
    below = ((torch.cumsum(alpha * STEP, -1) < 1) & (alpha > 0)).numpy()
    exact = (up[:, :3].transpose(1, 2)[..., None] * STEP).numpy()
    got = np.broadcast_to(x.grad.numpy()[:, :, :3], exact.shape[:3]
                          + below.shape[-1:])
    want = np.broadcast_to(exact, got.shape)
    sel = np.broadcast_to(below[:, :, None], got.shape)
    assert sel[..., 5].mean() > 0.5        # the tiny steps, mostly below
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-6)
    # autograd of the float32 expressions misses it at the tiny steps
    x32 = acc.clone().requires_grad_()
    (_expressions(x32, live) * up).sum().backward()
    assert not np.allclose(x32.grad.numpy()[..., 5], ref[..., 5], rtol=1e-4,
                           atol=1e-5 * scale)


def _faint_grads():
    """(jax.grad in float32, the port's march in float32, the port's march
    in float64) of sum(rgba * up) on seed 0's scene with the alpha of every
    other prim scaled by 1e-9, by name."""
    names = ("primpos", "primrot", "primscale", "template")
    scene = [np.array(a) for a in _scene(0)]
    scene[3][1::2, 3] *= 1e-9
    rp, rd, tminmax, K_cam, Rt = _rays()
    kw = MARCH_CASES["exact"][0]
    up = np.random.RandomState(9).randn(4, *rp.shape[:2]).astype(np.float32)

    def f(*args):
        out = jm.mvp_raymarch_tiled(
            jnp.asarray(rp), jnp.asarray(rd), 0.05, jnp.asarray(tminmax),
            *args, jnp.asarray(K_cam), jnp.asarray(Rt), **kw)
        return jnp.sum(out * up)

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in scene))
    port = []
    for dtype in (torch.float32, torch.float64):
        def T(a):
            return torch.from_numpy(np.array(a)).to(dtype)
        leaves = [T(a).requires_grad_() for a in scene]
        out = tm.mvp_raymarch_tiled(T(rp), T(rd), 0.05, T(tminmax), *leaves,
                                    T(K_cam), T(Rt), **kw)
        (out * T(up)).sum().backward()
        port.append({k: v.grad.double().numpy()
                     for k, v in zip(names, leaves)})
    return ({k: np.asarray(v, np.float64) for k, v in zip(names, ref)},
            *port)


def test_faint_steps_depart_from_jax_grad():
    jax_g, port, truth = _faint_grads()
    for name, r in truth.items():
        scale = float(np.abs(r).max())
        assert scale > 0 and np.isfinite(r).all(), name
        np.testing.assert_allclose(port[name], r, rtol=GRAD_RTOL,
                                   atol=GRAD_OF_SCALE * scale, err_msg=name)
        if name != "template":
            np.testing.assert_allclose(jax_g[name], r, rtol=GRAD_RTOL,
                                       atol=GRAD_OF_SCALE * scale,
                                       err_msg=name)
    r, j = truth["template"], jax_g["template"]
    scale = float(np.abs(r).max())
    np.testing.assert_allclose(j[0::2], r[0::2], rtol=GRAD_RTOL,
                               atol=GRAD_OF_SCALE * scale)
    assert float(np.abs(j[1::2] - r[1::2]).max()) > 1e-3 * scale
