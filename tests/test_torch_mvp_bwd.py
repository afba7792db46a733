"""K10's plain version (goliath_torch/ops/mvp_cuda.py
``mvp_march_backward_plain``: autograd of the plain tile groups over the
per-tile inputs the kernels take) against ``jax.grad`` of the JAX package's
jitted ``mvp_raymarch_tiled`` on the CPU, on tests/test_torch_mvp_grad.py's
cases: ``MARCH_CASES`` (every drop of the march occurring) and the warp
test's scene. The upstream gradient of the image is carried onto the tiles
through ``untile``, and the rows' gradients back onto the template and the
warp field through ``pack_volume``.

Tolerance: tests/test_torch_mvp_grad.py's, rtol 1e-4 plus 1e-4 of each
gradient's largest |reference| entry (float32 sums of taps taken in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_torch.ops import mvp_cuda as mc
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import T
from tests.test_torch_mvp_grad import CASES, GRAD_OF_SCALE, GRAD_RTOL, _inputs

torch.set_num_threads(1)


def jax_grads(case):
    """(rgba [4, H, W], the gradients of sum(rgba * up) by name) of the
    jitted JAX march."""
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, up = _inputs(case)
    names = [k for k, v in diff.items() if v is not None]

    def f(*args):
        d = dict(zip(names, args))
        out = jm.mvp_raymarch_tiled(
            jnp.asarray(rp), jnp.asarray(rd), stepsize, jnp.asarray(tminmax),
            d["primpos"], d["primrot"], d["primscale"], d["template"],
            jnp.asarray(K_cam), jnp.asarray(Rt), warp=d.get("warp"), **kw)
        return jnp.sum(out * up), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(diff[k]) for k in names))
    return np.asarray(out), {k: np.asarray(g) for k, g in zip(names, grads)}


def plain_backward_grads(case):
    """The same gradients through ``march_inputs`` and
    ``mvp_march_backward_plain``: the image's upstream gradient onto the
    tiles (``untile``'s backward), the rows' onto the template and the
    warp (``pack_volume``'s)."""
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, up = _inputs(case)
    vols = {k: T(diff[k]).requires_grad_() for k in ("template", "warp")
            if diff[k] is not None}
    inp, _, _ = tm.march_inputs(
        T(rp), T(rd), stepsize, T(tminmax), T(diff["primpos"]),
        T(diff["primrot"]), T(diff["primscale"]), vols["template"], T(K_cam),
        T(Rt), warp=vols.get("warp"), **kw)
    tiles = torch.zeros(inp.raypos.shape[0], 4, inp.raypos.shape[1],
                        requires_grad=True)
    grad_out, = torch.autograd.grad(tm.untile(inp, tiles), tiles, T(up))
    g = mc.mvp_march_backward_plain(inp, grad_out)
    got = {k: g[k] for k in ("primpos", "primrot", "primscale")}
    got["template"], = torch.autograd.grad(inp.template.rows,
                                           vols["template"], g["rows"])
    if "warp" in vols:
        got["warp"], = torch.autograd.grad(inp.warp.rows, vols["warp"],
                                           g["wrows"])
    else:
        assert g["wrows"] is None
    return got


def hold(case):
    out, ref = jax_grads(case)
    got = plain_backward_grads(case)
    assert float(out[3].max()) > 0.3   # a visible scene
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = float(np.abs(r).max())
        assert scale > 0 and np.isfinite(r).all(), name
        np.testing.assert_allclose(got[name].numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_OF_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES)[0:4])
def test_plain_k10_matches_jax_grad(case):
    hold(case)
