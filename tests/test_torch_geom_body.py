"""Parity of the port's body-geometry helpers with the JAX package on the
CPU: ``utils/geom.py``'s ``compute_tbn_uv``,
``compute_tbn_uv_given_normal`` and ``convert_camera_parameters``,
``utils/geom_body.py`` (its re-exports and misspelt aliases, the Rodrigues
inverse, Euler angles, ``acos_safe`` at and around its ties,
``interpolate_values_mesh``, the TBN-space view conditioning, and the
host-side closest-point helpers), and ``utils/quaternion.py``
``rigid_align``. Values, and gradients where the JAX function is
differentiable, on the same seeded inputs.

Tolerances: values and gradients at rtol 1e-5 plus 1e-5 of the output's
largest |value| (float32 elementwise arithmetic and small sums in other
orders); ``acos_safe``'s gradient at its ties at rtol 1e-4 (both packages
halve the clip's gradient there and give |x| the gradient +1 at 0; the
arccos derivative at 1 - eps cancels in float32);
``rigid_align`` at rtol 1e-4 + 1e-5 of scale (an SVD: LAPACK in both, with
its own sign choices), a known rotation recovered to 1e-5; the numpy
helpers bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.utils import geom as tg
from goliath_torch.utils import geom_body as tgb
from goliath_torch.utils import quaternion as tq
from goliath_tpu.utils import geom as jg
from goliath_tpu.utils import geom_body as jgb
from goliath_tpu.utils import quaternion as jq
from tests.drivable_fixture import dataset

torch.set_num_threads(1)

TOL = 1e-5


def close(got, ref, rtol=TOL, of_scale=TOL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=of_scale * float(np.abs(ref).max()),
                               err_msg=err_msg)


def value_and_grads(t_fn, j_fn, inputs, cotangent_seed=0):
    """Both packages' outputs and the gradients of <outputs, w> for a
    seeded cotangent w of each output, with respect to every input."""
    t_in = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_out = t_fn(*t_in)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    rng = np.random.RandomState(cotangent_seed)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in t_out]
    sum(torch.sum(o * torch.from_numpy(w))
        for o, w in zip(t_out, ws)).backward()
    t_grads = [x.grad.numpy() for x in t_in]

    def j_loss(*xs):
        out = j_fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws)), out

    (_, j_out), j_grads = jax.value_and_grad(
        j_loss, argnums=tuple(range(len(inputs))), has_aux=True)(
        *map(jnp.asarray, inputs))
    return ([o.detach().numpy() for o in t_out], t_grads,
            [np.asarray(o) for o in j_out], [np.asarray(g) for g in j_grads])


def hold(t_fn, j_fn, inputs, label, rtol=TOL, of_scale=TOL):
    t_out, t_g, j_out, j_g = value_and_grads(t_fn, j_fn, inputs)
    for i, (g, r) in enumerate(zip(t_out, j_out)):
        close(g, r, rtol, of_scale, f"{label} output {i}")
    for i, (g, r) in enumerate(zip(t_g, j_g)):
        close(g, r, rtol, of_scale, f"{label} gradient {i}")


def test_geom_tbn_and_camera_functions_match_jax():
    rng = np.random.RandomState(0)
    tri_xyz = rng.randn(2, 50, 3, 3).astype(np.float32)
    tri_uv = rng.rand(50, 3, 2).astype(np.float32)
    normals = rng.randn(2, 50, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    # one texel of zero UV area: the given-normal frame takes 1e-8 there
    tri_uv[7, 2] = tri_uv[7, 0]
    hold(tg.compute_tbn_uv, jg.compute_tbn_uv,
         (tri_xyz[:, 8:], tri_uv[8:]), "compute_tbn_uv")
    hold(tg.compute_tbn_uv_given_normal, jg.compute_tbn_uv_given_normal,
         (tri_xyz, tri_uv, normals), "compute_tbn_uv_given_normal",
         rtol=1e-4, of_scale=1e-5)
    Rt = rng.randn(3, 3, 4).astype(np.float32)
    K = rng.randn(3, 3, 3).astype(np.float32)
    got = tg.convert_camera_parameters(torch.from_numpy(Rt),
                                       torch.from_numpy(K))
    ref = jg.convert_camera_parameters(jnp.asarray(Rt), jnp.asarray(K))
    assert set(got) == set(ref) == {"campos", "camrot", "focal", "princpt"}
    for k in ref:
        close(got[k], ref[k], err_msg=k)
    hold(lambda r, k: tuple(tg.convert_camera_parameters(r, k).values()),
         lambda r, k: tuple(jg.convert_camera_parameters(r, k).values()),
         (Rt, K), "convert_camera_parameters")


def test_geom_body_functions_match_jax():
    for name in ("GeometryModule", "compute_neighbours", "compute_tbn",
                 "compute_tbn_uv", "compute_v2uv", "compute_view_cos",
                 "convert_camera_parameters", "depth_discontinuity_mask",
                 "face_normals", "index_image_impaint", "make_postex",
                 "make_uv_barys", "make_uv_vert_index", "sample_uv",
                 "values_to_uv", "vert_normals"):
        assert getattr(tgb, name) is getattr(tg, name), name
        assert hasattr(jgb, name), name
    assert tgb.depth_discontuity_mask is tg.depth_discontinuity_mask
    assert tgb.face_normals_v2 is tg.face_normals
    assert tgb.vert_normals_v2 is tg.vert_normals
    for name in ("axisangle_to_matrix", "matrix_to_axisangle",
                 "quat_from_xyz", "quat_to_matrix"):
        assert getattr(tgb, name) is getattr(tq, name), name

    rng = np.random.RandomState(1)
    rvec = rng.randn(6, 3).astype(np.float32)
    R = np.asarray(jq.axisangle_to_matrix(jnp.asarray(rvec)))
    hold(tgb.inv_rodrigues, jgb.inv_rodrigues, (R,), "inv_rodrigues")
    hold(tgb.euler_xyz_to_matrix, jgb.euler_xyz_to_matrix, (rvec,),
         "euler_xyz_to_matrix")

    eps = 1e-4
    x = np.concatenate([
        rng.uniform(-1.5, 1.5, 40),
        [0.0, 1 - eps, -(1 - eps), 1.0, -1.0, 1.2]]).astype(np.float32)
    hold(tgb.acos_safe, jgb.acos_safe, (x,), "acos_safe")
    t_x = torch.tensor(x, requires_grad=True)
    tgb.acos_safe(t_x).sum().backward()
    j_g = np.asarray(jax.grad(lambda v: jgb.acos_safe(v).sum())(
        jnp.asarray(x)))
    # the ties: x = 0 (|x|'s gradient +1), x = +-(1 - eps) (half the
    # clip's gradient, 1 / sqrt(1 - x^2) cancelling in float32), |x| = 1
    np.testing.assert_allclose(t_x.grad.numpy()[-6:], j_g[-6:], rtol=1e-4)
    slope = 1.0 / np.sqrt(1.0 - np.float64(x[-5]) ** 2)
    np.testing.assert_allclose(t_x.grad.numpy()[-5:-3], -slope / 2,
                               rtol=1e-3)
    assert np.isfinite(j_g).all()

    v2 = rng.randn(20, 4).astype(np.float32)
    v3 = rng.randn(2, 20, 4).astype(np.float32)
    faces = rng.randint(0, 20, (30, 3))
    idxs = rng.randint(0, 30, 25)
    w = rng.dirichlet(np.ones(3), 25).astype(np.float32)
    for vals in (v2, v3):
        hold(lambda v, ww: tgb.interpolate_values_mesh(
                 v, torch.from_numpy(faces), torch.from_numpy(idxs), ww),
             lambda v, ww: jgb.interpolate_values_mesh(
                 v, jnp.asarray(faces), jnp.asarray(idxs), ww),
             (vals, w), f"interpolate_values_mesh {vals.ndim}-D")

    ds = dataset()
    topo = ds.static_assets.topology
    args = (np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv))
    t_geo = tg.GeometryModule(*args, uv_size=32, impaint=True, device="cpu")
    j_geo = jg.GeometryModule(*args, uv_size=32, impaint=True)
    geom = (np.asarray(ds.static_assets.template_mesh_unscaled)[None]
            + rng.randn(2, len(topo.v), 3) * 5).astype(np.float32)
    campos = rng.randn(2, 3).astype(np.float32) * 500
    hold(lambda g, c: tgb.compute_view_cond_tbnrefl(g, c, t_geo),
         lambda g, c: jgb.compute_view_cond_tbnrefl(g, c, j_geo),
         (geom, campos), "compute_view_cond_tbnrefl", rtol=1e-4,
         of_scale=1e-5)


def test_geom_body_host_helpers_are_bit_equal():
    ds = dataset()
    topo = ds.static_assets.topology
    v = np.asarray(ds.static_assets.template_mesh_unscaled, np.float32)
    vi = np.asarray(topo.vi)
    rng = np.random.RandomState(2)
    points = (v[rng.randint(0, len(v), 40)]
              + rng.randn(40, 3).astype(np.float32) * 20)
    for t_out, j_out in (
            (tgb.closest_point(v, vi, points, chunk=16),
             jgb.closest_point(v, vi, points, chunk=16)),
            (tgb.closest_point_barycentrics(v, vi, points),
             jgb.closest_point_barycentrics(v, vi, points))):
        for g, r in zip(t_out, j_out):
            np.testing.assert_array_equal(g, r)
    tri = rng.randn(10, 3, 3)
    pts = rng.randn(10, 3)
    np.testing.assert_array_equal(tgb.points_to_barycentric(tri, pts),
                                  jgb.points_to_barycentric(tri, pts))
    uvs = rng.rand(12, 2)
    topo_dict = {"vi": topo.vi, "vt": topo.vt, "vti": topo.vti}
    for g, r in zip(tgb.get_barys_for_uvs(topo_dict, uvs),
                    jgb.get_barys_for_uvs(topo_dict, uvs)):
        np.testing.assert_array_equal(g, r)
    for flip in (True, False):
        for g, r in zip(
                tgb.make_closest_uv_barys(np.asarray(topo.vt),
                                          np.asarray(topo.vti), 24, flip),
                jgb.make_closest_uv_barys(np.asarray(topo.vt),
                                          np.asarray(topo.vti), 24, flip)):
            np.testing.assert_array_equal(g, r)
    face_index, _ = tgb.make_closest_uv_barys(np.asarray(topo.vt),
                                              np.asarray(topo.vti), 24)
    assert (face_index >= 0).all()


def test_rigid_align_recovers_a_rotation_and_matches_jax():
    rng = np.random.RandomState(3)
    src = rng.randn(2, 30, 3).astype(np.float32)
    R_true = np.asarray(jq.axisangle_to_matrix(jnp.asarray(
        np.array([[0.3, -1.1, 0.6], [2.0, 0.4, -0.2]], np.float32))))
    t_true = np.array([[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]], np.float32)
    tgt = np.einsum("bij,bnj->bni", R_true, src) + t_true[:, None]
    weights = rng.rand(2, 30).astype(np.float32)
    for w in (None, weights):
        t_w = None if w is None else torch.from_numpy(w)
        R, t = tq.rigid_align(torch.from_numpy(src), torch.from_numpy(tgt),
                              t_w)
        np.testing.assert_allclose(R.numpy(), R_true, atol=1e-5)
        np.testing.assert_allclose(t.numpy(), t_true, atol=1e-5)
        assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)
    # a noisy target, and one mirrored (the det correction), weighted and
    # not, with gradients
    noisy = tgt + rng.randn(*tgt.shape).astype(np.float32) * 0.3
    mirrored = noisy * np.array([1, 1, -1], np.float32)
    for target in (noisy, mirrored):
        hold(tq.rigid_align, jq.rigid_align, (src, target),
             "rigid_align", rtol=1e-4)
        hold(tq.rigid_align, jq.rigid_align, (src, target, weights),
             "rigid_align weighted", rtol=1e-4)
    R, _ = tq.rigid_align(torch.from_numpy(src), torch.from_numpy(mirrored))
    assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)
