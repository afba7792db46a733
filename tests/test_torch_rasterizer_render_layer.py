"""Part of tests/test_torch_rasterizer.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.ops import rasterizer as tr
from goliath_tpu.ops import rasterizer as jr

from tests.test_torch_rasterizer import ATOL, GRAD_RTOL, H, RTOL, W, _scene

torch.set_num_threads(1)


def test_render_layer_and_its_backward_match_jax():
    """The batched render, and the gradients of sum(render * w) with
    respect to the vertices (through the barycentrics, the texture
    coordinates and the edge-gradient backward) and the texture."""
    v, vi, vt, vti, K, Rt, _ = _scene()
    tex = np.random.RandomState(2).rand(2, 3, 32, 32).astype(np.float32)
    w = np.random.RandomState(4).randn(2, 3, H, W).astype(np.float32)
    verts = np.stack([v, v * 1.05])
    kw = dict(max_faces_per_tile=128, chunk=16)
    Kb, Rtb = jnp.asarray(np.repeat(K, 2, 0)), jnp.asarray(np.repeat(Rt, 2, 0))
    jrl = jr.RenderLayer(H, W, vi, vt, vti, **kw)

    def render(v_, t_):
        out = jrl(v_, t_, Kb, Rtb)
        return out["render"], out

    # the forward eagerly (see above); its backward holds no rasterization
    _, vjp, ref = jax.vjp(render, jnp.asarray(verts), jnp.asarray(tex),
                          has_aux=True)
    ref_gv, ref_gt = jax.jit(vjp)(jnp.asarray(w))
    rl = tr.RenderLayer(H, W, vi, vt, vti, device="cpu", **kw)
    tverts = torch.from_numpy(verts).requires_grad_(True)
    ttex = torch.from_numpy(tex).requires_grad_(True)
    got = rl(tverts, ttex, torch.from_numpy(np.repeat(K, 2, 0)),
             torch.from_numpy(np.repeat(Rt, 2, 0)))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["index_img"].numpy(),
                                  np.asarray(ref["index_img"]))
    for k in ("render", "depth_img", "v_pix", "vt_img", "bary_img", "mask"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=1e-4 if k == "v_pix" else ATOL,
                                   rtol=RTOL, err_msg=k)
    assert float(got["mask"].mean()) > 0.2
    (got["render"] * torch.from_numpy(w)).sum().backward()
    for name, g, r in (("verts", tverts.grad, ref_gv), ("tex", ttex.grad,
                                                        ref_gt)):
        r = np.asarray(r)
        assert float(np.abs(r).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(r).max()),
                                   err_msg=name)
