"""Part of tests/test_torch_urhand.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.utils import geom as tgeom, quaternion as tq
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.utils import geom as jgeom, quaternion as jq

from tests.test_torch_mesh_vae import close_to_scale
from tests.test_torch_urhand import RTOL, _t

torch.set_num_threads(1)


def test_quaternions_and_projections_match_jax():
    rng = np.random.RandomState(0)
    eul = (rng.randn(64, 3) * 2.0).astype(np.float32)
    # rotations of every branch of matrix_to_quat, angles near pi included
    R = np.asarray(jq.quat_to_matrix(jq.quat_from_xyz(jnp.asarray(eul))))
    R = np.concatenate([R, np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None],
                        np.diag([-1.0, 1.0, -1.0]).astype(np.float32)[None],
                        np.diag([-1.0, -1.0, 1.0]).astype(np.float32)[None]])
    for name in ("matrix_to_quat", "matrix_to_axisangle"):
        got = getattr(tq, name)(_t(R)).numpy()
        ref = np.asarray(getattr(jq, name)(jnp.asarray(R)))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL,
                                   err_msg=name)
    rvec = (rng.randn(32, 3)).astype(np.float32)
    rvec[0] = 0.0
    np.testing.assert_allclose(
        tq.axisangle_to_matrix(_t(rvec)).numpy(),
        np.asarray(jq.axisangle_to_matrix(jnp.asarray(rvec))),
        rtol=RTOL, atol=RTOL)
    v = rng.randn(16, 5).astype(np.float32)
    np.testing.assert_allclose(tq.normalize(_t(v), dim=0).numpy(),
                               np.asarray(jq.normalize(jnp.asarray(v), 0)),
                               rtol=RTOL, atol=1e-7)

    # points on both sides of the cameras: the division keeps sign(depth)
    p = (rng.randn(2, 50, 3) * 3.0).astype(np.float32)
    Rt = np.concatenate([np.asarray(jq.quat_to_matrix(jq.quat_from_xyz(
        jnp.asarray(rng.randn(2, 3, 3).astype(np.float32))))),
        rng.randn(2, 3, 3, 1).astype(np.float32)], -1)
    K = np.tile(np.asarray([[500.0, 0, 24], [0, 500.0, 20], [0, 0, 1]],
                           np.float32), (2, 3, 1, 1))
    for norm in (False, True):
        kw = dict(normalize=norm, size=(40, 48))
        got = tgeom.project_points_multi(_t(p), _t(Rt), _t(K), **kw)
        ref = jgeom.project_points_multi(jnp.asarray(p), jnp.asarray(Rt),
                                         jnp.asarray(K), **kw)
        got1 = tgeom.project_points(_t(p), _t(Rt[:, 0]), _t(K[:, 0]), **kw)
        ref1 = jgeom.project_points(jnp.asarray(p), jnp.asarray(Rt[:, 0]),
                                    jnp.asarray(K[:, 0]), **kw)
        for g, r in zip(got + got1, ref + ref1):
            close_to_scale(g.numpy(), r)
    assert (ref[1] < 0).any() and (ref[1] > 0).any()


def test_focus_losses_match_jax():
    rng = np.random.RandomState(1)
    preds = {k: (rng.rand(2, 3, 16, 16) * 255).astype(np.float32)
             for k in ("rendered_rgb", "rendered_phys_rgb")}
    preds["rendered_mask"] = (rng.rand(2, 1, 16, 16) > 0.3).astype(np.float32)
    preds["depth_disc_mask"] = (rng.rand(2, 1, 16, 16) > 0.9).astype(
        np.float32)
    targets = {"image": (rng.rand(2, 3, 16, 16) * 255).astype(np.float32),
               "image_mask": (rng.rand(2, 1, 16, 16) > 0.2).astype(
                   np.float32)}
    cfg = {"rgb_l1_focus": {"weight": 1.0, "self_mask": True},
           "rgb_l1_phys": {"weight": 0.5, "mask_erode": 3},
           "list_l1_reg": {"weight": 1e-4, "key": "interm_features2reg"}}
    feats = [rng.randn(2, c, s, s).astype(np.float32)
             for c, s in ((8, 2), (4, 4))]

    def jloss(p, f):
        total, d = JModularLoss(cfg)({**p, "interm_features2reg": f},
                                     {k: jnp.asarray(v)
                                      for k, v in targets.items()})
        return total, d

    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    (jtotal, jd), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jp, [jnp.asarray(f) for f in feats])
    tp = {k: _t(v).requires_grad_(k != "rendered_mask")
          for k, v in preds.items()}
    tf = [_t(f).requires_grad_() for f in feats]
    ttotal, td = TModularLoss(cfg)({**tp, "interm_features2reg": tf},
                                   {k: _t(v) for k, v in targets.items()})
    ttotal.backward()
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=RTOL,
                                   err_msg=k)
    for k in ("rendered_rgb", "rendered_phys_rgb"):
        close_to_scale(tp[k].grad.numpy(), jgrads[0][k], err_msg=k)
    # the self mask takes no gradient
    assert tp["rendered_mask"].grad is None
    assert float(np.abs(np.asarray(jgrads[0]["rendered_mask"])).max()) == 0
    for g, r in zip(tf, jgrads[1]):
        close_to_scale(g.grad.numpy(), r)
