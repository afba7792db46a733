"""Part of tests/test_torch_cal_blur.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.nn import color_cal as tcal, dof_cal as tdof
from goliath_tpu.nn import dof_cal as jdof

from tests.test_torch_cal_blur import ATOL, CAMERAS, RTOL, _np_tree

torch.set_num_threads(1)


def test_calv5_missing_identity_camera_falls_back(caplog):
    with caplog.at_level("WARNING"):
        tm = tcal.CalV5(cameras=("401", "402"), identity_camera="999")
    assert tm.identity_idx == 0 and "defaulting" in caplog.text


@pytest.mark.parametrize("ksize", [3, 7])
def test_gaussian_blur_matches_jax(ksize):
    rng = np.random.RandomState(ksize)
    img = rng.rand(2, 3, 9, 12).astype(np.float32)
    ref = jdof.gaussian_blur(jnp.asarray(img), ksize)
    got = tdof.gaussian_blur(torch.from_numpy(img), ksize)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # "same" zero padding: a constant image darkens at the border only
    ones = tdof.gaussian_blur(torch.ones(1, 1, 9, 12), ksize)
    r = ksize // 2
    np.testing.assert_allclose(ones[0, 0, r:-r, r:-r].numpy(), 1.0, rtol=1e-6)
    assert float(ones[0, 0, 0, 0]) < 1.0


def test_learnable_blur_outputs_and_grads_match_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(3, 3, 8, 10).astype(np.float32)
    w_out = rng.standard_normal(img.shape).astype(np.float32)
    idx = np.asarray([2, 0, 2], np.int32)
    raw = rng.standard_normal((4, 3)).astype(np.float32)

    jm = jdof.LearnableBlur(cameras=CAMERAS)
    init = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(idx))
    assert np.array_equal(np.asarray(init["params"]["weights_raw"]),
                          np.ones((4, 3), np.float32))
    jparams = {"params": {"weights_raw": jnp.asarray(raw)}}

    def j_loss(p, x):
        out = jm.apply(p, x, jnp.asarray(idx))
        reg = jm.apply(p, jnp.asarray(idx), method=jm.reg)
        return (out * w_out).sum() + jnp.abs(reg - 1.0).mean(), (out, reg)

    (_, (ref, ref_reg)), (gp, gi) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(img))

    tm = tdof.LearnableBlur(cameras=CAMERAS)
    assert torch.equal(tm.weights_raw.detach(), torch.ones(4, 3))
    tm.load_state_dict(params_from_jax(_np_tree(jparams)), strict=True)
    t_img = torch.from_numpy(img).requires_grad_(True)
    t_idx = torch.from_numpy(idx)
    out, reg = tm(t_img, t_idx), tm.reg(t_idx)
    ((out * torch.from_numpy(w_out)).sum() + (reg - 1.0).abs().mean()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(ref_reg),
                               rtol=0, atol=0)
    np.testing.assert_allclose(tm.weights_raw.grad.numpy(),
                               np.asarray(gp["params"]["weights_raw"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_img.grad.numpy(), np.asarray(gi), rtol=RTOL,
                               atol=ATOL)
