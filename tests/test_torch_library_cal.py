"""The colour-calibration variants (nn/color_cal.py: ``Identity``,
``CalV3``, ``CalV5``, ``CalV6`` through ``make_cal``) against the JAX
package on the CPU: the identity at init, the affine of perturbed
parameters (forward and the gradients of ``cal_params`` and the image, at
tests/test_torch_library.py's tolerance), no gradient to the identity
camera's row (v3: detached, v6: replaced), v6 refusing gray cameras, and
the fallback to the first camera.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.nn import color_cal as tcc
from goliath_tpu.nn import color_cal as jcc
from tests.test_torch_library import hold

torch.set_num_threads(1)

CAMS = ["c0", "400870", "c2", "41ab"]   # a gray camera for v5


@pytest.mark.parametrize("ver", ["identity", "v3", "v5", "v6"])
def test_cal_matches_jax(ver):
    cams = CAMS[:3] if ver == "v6" else CAMS
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 1, (5, 3, 4, 6)).astype(np.float32)
    idx = np.asarray([0, 1, 2, len(cams) - 1, 1], np.int32)
    tmod = tcc.make_cal(ver, cameras=cams, identity_camera="400870")
    jmod = jcc.make_cal(ver, cameras=cams, identity_camera="400870")
    # at init: the identity for every camera but v5's gray one
    with torch.no_grad():
        out = tmod(torch.from_numpy(img), torch.from_numpy(idx))
    if ver != "v5":
        np.testing.assert_allclose(out.numpy(), img, atol=1e-6)
    # perturbed: each camera's own affine
    with torch.no_grad():
        tmod.cal_params.copy_(torch.from_numpy(
            1.0 + 0.3 * rng.randn(len(cams), 6).astype(np.float32)))
    got = hold(jmod, tmod, [img], jargs=(jnp.asarray(idx),),
               targs=(torch.from_numpy(idx),))
    p = tmod.cal_params.detach().numpy()
    if ver in ("v3", "v6"):
        want = img * p[idx, :3, None, None] + p[idx, 3:, None, None]
        if ver == "v6":   # the identity camera's row is the identity
            want[idx == 1] = img[idx == 1]
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    if ver != "identity":
        assert not tmod.cal_params.grad[1].any()   # the identity camera's
        assert tmod.cal_params.grad[0].abs().sum() > 0


def test_cal_v6_refuses_gray_and_missing_identity_falls_back(caplog):
    with pytest.raises(ValueError):
        tcc.make_cal("v6", cameras=["41aaa", "c1"], identity_camera="c1")
    for ver in ("identity", "v3", "v5", "v6"):
        with caplog.at_level(logging.WARNING):
            m = tcc.make_cal(ver, cameras=["c0", "c1"], identity_camera="x")
        if ver != "identity":
            assert m.identity_idx == 0
            assert "defaulting to c0" in caplog.text
        else:   # as the JAX Identity, it reads no identity camera
            assert m.identity_idx is None and not caplog.text
        caplog.clear()
        np.testing.assert_array_equal(m.cal_params.detach().numpy(),
                                      [[1, 1, 1, 0, 0, 0]] * 2)
    assert m.name_to_idx(["c1", "c0"]).tolist() == [1, 0]
    assert isinstance(tcc.make_cal("v5", cameras=["a"],
                                   identity_camera="a"), tcc.CalV5)
