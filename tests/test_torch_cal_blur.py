"""Parity of the port's per-camera color calibration (``CalV5``, with its
gradient scaler) and learnable defocus blur with the JAX package on the CPU,
the parameters carried across with ``params_from_jax``.

Tolerances: rtol 1e-5 / atol 1e-6 on outputs and gradients (elementwise
float32 arithmetic and sums over an 8x10 image on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_tpu.nn import color_cal as jcal
from goliath_torch.convert import params_from_jax
from goliath_torch.nn import color_cal as tcal

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CAMERAS = ("400870", "410001", "401645", "410002")   # "41..." are grayscale


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("cam_idxs", [
    (0, 1, 2, 3),     # identity, grey, color, grey
    (2, 2, 0, 0),     # repeated cameras: their gradients add
    (1, 3, 3, 1),     # grey only
])
def test_calv5_outputs_and_scaled_grads_match_jax(cam_idxs):
    rng = np.random.RandomState(0)
    image = rng.rand(4, 3, 8, 10).astype(np.float32)
    w_out = rng.standard_normal(image.shape).astype(np.float32)
    table = (rng.standard_normal((4, 6)) * 0.3 + 1.0).astype(np.float32)
    idx = np.asarray(cam_idxs, np.int32)
    kw = dict(identity_camera="400870", gs_lrscale=0.7, col_lrscale=0.1)

    jm = jcal.CalV5(cameras=CAMERAS, **kw)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.asarray(image),
                      jnp.asarray(idx))
    init = np.asarray(jparams["params"]["cal_params"])
    jparams = {"params": {"cal_params": jnp.asarray(table)}}

    def j_loss(p, img):
        out = jm.apply(p, img, jnp.asarray(idx))
        return (out * w_out).sum(), out

    (_, ref), (ref_gp, ref_gi) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(image))

    tm = tcal.CalV5(cameras=CAMERAS, **kw)
    # the same initial table (grey gains 0.37/0.52/0.52), then the test's
    np.testing.assert_array_equal(tm.cal_params.detach().numpy(), init)
    tm.load_state_dict(params_from_jax(_np_tree(jparams)), strict=True)
    t_img = torch.from_numpy(image).requires_grad_(True)
    out = tm(t_img, torch.from_numpy(idx))
    (out * torch.from_numpy(w_out)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tm.cal_params.grad.numpy(),
        np.asarray(ref_gp["params"]["cal_params"]), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(t_img.grad.numpy(), np.asarray(ref_gi),
                               rtol=RTOL, atol=ATOL)
    # the identity camera passes through and takes no parameter gradient
    for b, c in enumerate(cam_idxs):
        if c == 0:
            np.testing.assert_array_equal(out[b].detach().numpy(), image[b])
    if 0 in cam_idxs:
        assert not tm.cal_params.grad[0].any()
    assert torch.equal(tm.name_to_idx(["401645", "400870"]),
                       torch.tensor([2, 0], dtype=torch.int32))


def test_scale_grad_scales_only_the_gradient():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    scale = torch.tensor([[1.0], [0.1]])
    y = tcal.scale_grad(x, scale)
    assert torch.equal(y, x)
    (y * 2.0).sum().backward()
    assert torch.equal(x.grad, torch.tensor([[2.0] * 3, [0.2] * 3]))
