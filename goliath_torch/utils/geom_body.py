"""Body-capture geometry helpers (port of the JAX package's
utils/geom_body.py).

The JAX module re-exports the shared implementations of ``utils/geom.py``
(with the reference's old spellings as aliases) and adds the body-only
helpers: closest-point UV barycentrics, the Rodrigues inverse, Euler
angles, a NaN-gradient-free arccos and the TBN-space view conditioning.
The closest-point helpers are host-side numpy in both packages, copied so
that they give the same bits.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from goliath_torch.utils.geom import (  # noqa: F401 — re-exported API
    GeometryModule,
    compute_neighbours,
    compute_tbn,
    compute_tbn_uv,
    compute_v2uv,
    compute_view_cos,
    convert_camera_parameters,
    depth_discontinuity_mask,
    face_normals,
    index_image_impaint,
    make_postex,
    make_uv_barys,
    make_uv_vert_index,
    sample_uv,
    values_to_uv,
    vert_normals,
)
from goliath_torch.utils.image import absolute, clip
from goliath_torch.utils.quaternion import (  # noqa: F401 — re-exported API
    axisangle_to_matrix,
    matrix_to_axisangle,
    quat_from_xyz,
    quat_to_matrix,
)

# the reference file spells it this way
depth_discontuity_mask = depth_discontinuity_mask
face_normals_v2 = face_normals
vert_normals_v2 = vert_normals


def inv_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle."""
    return matrix_to_axisangle(R)


def euler_xyz_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ Euler angles -> rotation matrix."""
    return quat_to_matrix(quat_from_xyz(euler))


def acos_safe(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """arccos without NaN gradients: inside |x| <= 1 - eps itself, outside
    its tangent line at +-(1 - eps). The clip and |x| take the JAX
    package's gradients at their ties."""
    slope = float(np.arccos(1 - eps) / eps)
    sign = torch.sign(x)
    ax = absolute(x)
    inner = torch.arccos(clip(x, -(1 - eps), 1 - eps))
    outer = torch.arccos(sign * (1 - eps)) - slope * sign * (ax - 1 + eps)
    return torch.where(ax <= 1 - eps, inner, outer)


def interpolate_values_mesh(src_values: torch.Tensor, src_faces: torch.Tensor,
                            idxs: torch.Tensor, weights: torch.Tensor
                            ) -> torch.Tensor:
    """Barycentric interpolation of per-vertex values [N, F] or [B, N, F]
    at (face ``idxs``, ``weights`` [M, 3]) samples."""
    if src_values.dim() == 2:
        return (src_values[src_faces[idxs]] * weights[..., None]).sum(dim=1)
    return (src_values[:, src_faces[idxs]]
            * weights[None, ..., None]).sum(dim=2)


def _closest_point_triangle(p: np.ndarray, a: np.ndarray, b: np.ndarray,
                            c: np.ndarray) -> np.ndarray:
    """Exact closest point on triangles [M, 3] for points [M, 3]
    (Ericson, Real-Time Collision Detection §5.1.5), vectorized."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    v_ab = np.clip(d1 / np.where(d1 != d3, d1 - d3, 1.0), 0, 1)
    w_ac = np.clip(d2 / np.where(d2 != d6, d2 - d6, 1.0), 0, 1)
    w_bc = np.clip(
        (d4 - d3) / np.where((d4 - d3) + (d5 - d6) != 0,
                             (d4 - d3) + (d5 - d6), 1.0), 0, 1)
    # interior barycentrics
    denom = np.where(va + vb + vc != 0, va + vb + vc, 1.0)
    v_in = vb / denom
    w_in = vc / denom
    out = a + ab * v_in[..., None] + ac * w_in[..., None]
    # edge BC region
    cond_bc = (d4 - d3 >= 0) & (d5 - d6 >= 0) & (va <= 0)
    out = np.where(cond_bc[..., None], b + (c - b) * w_bc[..., None], out)
    # edge AC region
    cond_ac = (d2 >= 0) & (d6 <= 0) & (vb <= 0)
    out = np.where(cond_ac[..., None], a + ac * w_ac[..., None], out)
    # edge AB region
    cond_ab = (d1 >= 0) & (d3 <= 0) & (vc <= 0)
    out = np.where(cond_ab[..., None], a + ab * v_ab[..., None], out)
    # vertex regions
    out = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    return out


def closest_point(v: np.ndarray, vi: np.ndarray, points: np.ndarray,
                  chunk: int = 512):
    """Closest point on a triangle mesh for each query point, by chunked
    exact point-triangle tests on the host.

    Returns (p [M, 3], sq_dist [M], face_idxs [M])."""
    v = np.asarray(v, np.float64)
    vi = np.asarray(vi, np.int64)
    points = np.asarray(points, np.float64)
    tri = v[vi]  # [F, 3, 3]
    M = points.shape[0]
    out_p = np.zeros((M, 3))
    out_d = np.zeros(M)
    out_f = np.zeros(M, np.int64)
    for s in range(0, M, chunk):
        p = points[s:s + chunk][:, None]            # [m, 1, 3]
        cp = _closest_point_triangle(
            p, tri[None, :, 0], tri[None, :, 1], tri[None, :, 2])  # [m, F, 3]
        d = np.sum((cp - p) ** 2, -1)               # [m, F]
        fi = np.argmin(d, axis=1)
        r = np.arange(cp.shape[0])
        out_p[s:s + chunk] = cp[r, fi]
        out_d[s:s + chunk] = d[r, fi]
        out_f[s:s + chunk] = fi
    return out_p, out_d, out_f


def points_to_barycentric(triangles: np.ndarray,
                          points: np.ndarray) -> np.ndarray:
    """Barycentric coordinates of points w.r.t. triangles [M, 3, 3]."""
    a, b, c = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    v0 = b - a
    v1 = c - a
    v2 = points - a
    d00 = np.sum(v0 * v0, -1)
    d01 = np.sum(v0 * v1, -1)
    d11 = np.sum(v1 * v1, -1)
    d20 = np.sum(v2 * v0, -1)
    d21 = np.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    denom = np.where(np.abs(denom) < 1e-17, 1.0, denom)
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    bu = 1.0 - bv - bw
    return np.stack([bu, bv, bw], -1)


def closest_point_barycentrics(v: np.ndarray, vi: np.ndarray,
                               points: np.ndarray):
    """Returns (approx, barys, interp_idxs, face_idxs): each point's closest
    point on the mesh, rebuilt from its face's barycentrics."""
    v = np.asarray(v, np.float64)
    vi = np.asarray(vi, np.int64)
    p, _, face_idxs = closest_point(v, vi, points)
    barys = points_to_barycentric(v[vi[face_idxs]], p)
    interp_idxs = vi[face_idxs]
    approx = np.einsum("mk,mkd->md", barys, v[interp_idxs])
    return approx, barys, interp_idxs, face_idxs


def get_barys_for_uvs(topology, uv_correspondences: np.ndarray):
    """UV correspondences -> (barycentrics, face vertex ids)."""
    vi = np.asarray(topology["vi"])
    vt = np.asarray(topology["vt"])
    vti = np.asarray(topology["vti"])
    vth = np.hstack((vt[:, :2], vt[:, :1] * 0))
    kp_uv_h = np.hstack((uv_correspondences, uv_correspondences[:, :1] * 0))
    _, kp_barys, _, face_indices = closest_point_barycentrics(
        vth, vti, kp_uv_h)
    kp_verts = vi[face_indices]
    return kp_barys, kp_verts


def compute_view_cond_tbnrefl(geom: torch.Tensor, campos: torch.Tensor,
                              geo_fn: GeometryModule) -> torch.Tensor:
    """Per-texel view vector in TBN space and the reflection vector,
    concatenated as [B, 6, S, S]."""
    B = geom.shape[0]
    S = geo_fn.uv_size
    index_image = geo_fn.index_image.long()
    mask = (index_image != -1).any(dim=-1)            # [S, S]
    idxs = torch.where(mask[..., None], index_image,
                       torch.zeros_like(index_image))  # [S, S, 3]
    tri_uv = geo_fn.vt[geo_fn.v2uv[idxs, 0]]          # [S, S, 3, 2]
    tri_xyz = geom[:, idxs]                           # [B, S, S, 3, 3]
    t, b, n = compute_tbn_uv(tri_xyz.reshape(B, -1, 3, 3),
                             tri_uv.reshape(-1, 3, 2))
    tbn_rot = torch.stack((t, -b, n), dim=-2).reshape(B, S, S, 3, 3)
    tbn_rot = tbn_rot * mask[None, :, :, None, None]
    view = campos[:, None] - geom
    view = view / torch.sqrt(torch.sum(view * view, -1, keepdim=True)
                             + 1e-12)
    v_uv = geo_fn.to_uv(view)                         # [B, 3, S, S]
    tbn_uv = torch.einsum("bhwij,bjhw->bihw", tbn_rot, v_uv)
    n_uv = n.reshape(B, S, S, 3).permute(0, 3, 1, 2) * mask[None, None]
    n_dot_v = (v_uv * n_uv).sum(dim=1, keepdim=True)
    r_uv = 2.0 * n_uv * n_dot_v - v_uv
    return torch.cat([tbn_uv, r_uv], dim=1)


def make_closest_uv_barys(
    vt: np.ndarray,
    vti: np.ndarray,
    uv_size: Union[int, Tuple[int, int]],
    flip_uv: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric map assigning every texel to its closest UV triangle:
    the UV rasterization, with each off-island texel taking the entries of
    its nearest covered texel."""
    face_index, bary = make_uv_barys(vt, vti, uv_size, flip_uv=flip_uv)
    face_index, bary = index_image_impaint(
        face_index, bary, distance_threshold=float("inf"))
    return face_index, bary
