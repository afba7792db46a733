"""UV-domain geometry core (port of the JAX package's utils/geom.py, the part
the RGCA and mesh_vae paths use).

* Host-side tables (numpy, computed once when a ``GeometryModule`` is
  built): rasterize the UV layout into per-texel face/vertex-index and
  barycentric images, optionally impainted from the nearest valid texel
  (scipy's Euclidean distance transform); vertex -> texcoord and
  first-ring neighbour tables. Copied from the JAX package so that this
  package never imports it.
* Device-side ops (torch): vertex -> UV transfer (``values_to_uv``, a
  gather and a barycentric lerp), UV -> vertex sampling, vertex normals,
  view cosines, the depth-discontinuity mask, depth -> camera-space XYZ ->
  normals.

* Pinhole projections (``project_points``, ``project_points_multi``) for
  URHand's shadow maps.
* Per-face TBN frames (``compute_tbn``) and UV position maps
  (``make_postex``) for the MVP hand's primitive bases; per-texel TBN
  frames (``compute_tbn_uv``, ``compute_tbn_uv_given_normal``) and the
  camera parameters of an ``Rt`` and ``K`` (``convert_camera_parameters``)
  for ``utils/geom_body.py``.

* View-texture unprojection (``compute_view_texture``, with the per-face
  and per-texel visibility of a rasterized face-id image) for
  ``run_gen_texmean``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device
from goliath_torch.utils.image import clip
from goliath_torch.utils.sampling import grid_sample

# ---------------------------------------------------------------------------
# host-side UV rasterization
# ---------------------------------------------------------------------------


def rasterize_uv_face_index(
    vt: np.ndarray, vti: np.ndarray, uv_size: Union[int, Tuple[int, int]],
    flip_uv: bool = True,
) -> np.ndarray:
    """Rasterize UV triangles -> per-texel face index ([-1] where empty).

    Texel (i, j) center is at uv = ((j+0.5)/W, (i+0.5)/H); ``flip_uv`` flips
    the V axis for OpenGL-convention topologies.
    """
    if isinstance(uv_size, int):
        uv_size = (uv_size, uv_size)
    H, W = uv_size
    vt = np.asarray(vt, dtype=np.float64).copy()
    vti = np.asarray(vti, dtype=np.int64)
    if flip_uv:
        vt[:, 1] = 1.0 - vt[:, 1]

    px = vt[:, 0] * W - 0.5
    py = vt[:, 1] * H - 0.5
    tx = px[vti]  # [F, 3]
    ty = py[vti]

    face_index = np.full((H, W), -1, dtype=np.int32)

    x0 = np.maximum(np.ceil(tx.min(1)).astype(np.int64), 0)
    x1 = np.minimum(np.floor(tx.max(1)).astype(np.int64), W - 1)
    y0 = np.maximum(np.ceil(ty.min(1)).astype(np.int64), 0)
    y1 = np.minimum(np.floor(ty.max(1)).astype(np.int64), H - 1)
    valid = (x1 >= x0) & (y1 >= y0)

    order = np.argsort((x1 - x0 + 1) * (y1 - y0 + 1))
    for f in order:
        if not valid[f]:
            continue
        xs = np.arange(x0[f], x1[f] + 1)
        ys = np.arange(y0[f], y1[f] + 1)
        gx, gy = np.meshgrid(xs, ys)
        b = _bary_2d(gx.ravel(), gy.ravel(), tx[f], ty[f])
        inside = (b >= -1e-9).all(axis=1)
        if inside.any():
            face_index[gy.ravel()[inside], gx.ravel()[inside]] = f
    return face_index


def _bary_2d(px: np.ndarray, py: np.ndarray, tx: np.ndarray, ty: np.ndarray,
             eps: float = 1e-12) -> np.ndarray:
    """Barycentric coords of points (px, py) wrt a single triangle."""
    x = px - tx[2]
    y = py - ty[2]
    x1, x2 = tx[0] - tx[2], tx[1] - tx[2]
    y1, y2 = ty[0] - ty[2], ty[1] - ty[2]
    denom = y2 * x1 - y1 * x2
    denom = np.where(denom >= 0, max(denom, eps), min(denom, -eps))
    b0 = (y2 * x - x2 * y) / denom
    b1 = (x1 * y - y1 * x) / denom
    return np.stack([b0, b1, 1.0 - b0 - b1], axis=-1)


def make_uv_vert_index(
    vt: np.ndarray, vi: np.ndarray, vti: np.ndarray,
    uv_size: Union[int, Tuple[int, int]], flip_uv: bool = True,
) -> np.ndarray:
    """[H, W, 3] mesh-vertex indices per texel; -1 where empty."""
    face_index = rasterize_uv_face_index(vt, vti, uv_size, flip_uv)
    vert_index = np.asarray(vi, dtype=np.int64)[face_index.clip(min=0)]
    vert_index[face_index < 0] = -1
    return vert_index.astype(np.int64)


def make_uv_barys(
    vt: np.ndarray, vti: np.ndarray,
    uv_size: Union[int, Tuple[int, int]], flip_uv: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """(face_index [H,W], bary [H,W,3]) per texel; zeros where empty."""
    if isinstance(uv_size, int):
        uv_size = (uv_size, uv_size)
    H, W = uv_size
    vt = np.asarray(vt, dtype=np.float64).copy()
    if flip_uv:
        vt[:, 1] = 1.0 - vt[:, 1]
    face_index = rasterize_uv_face_index(vt, np.asarray(vti), uv_size,
                                         flip_uv=False)

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    vti_map = np.asarray(vti, dtype=np.int64)[face_index.clip(min=0)]
    tx = (vt[:, 0] * W - 0.5)[vti_map]  # [H,W,3]
    ty = (vt[:, 1] * H - 0.5)[vti_map]

    x = gx - tx[..., 2]
    y = gy - ty[..., 2]
    x1, x2 = tx[..., 0] - tx[..., 2], tx[..., 1] - tx[..., 2]
    y1, y2 = ty[..., 0] - ty[..., 2], ty[..., 1] - ty[..., 2]
    denom = y2 * x1 - y1 * x2
    denom = np.where(denom >= 0, np.maximum(denom, 1e-12),
                     np.minimum(denom, -1e-12))
    b0 = (y2 * x - x2 * y) / denom
    b1 = (x1 * y - y1 * x) / denom
    bary = np.stack([b0, b1, 1.0 - b0 - b1], axis=-1)
    bary[face_index < 0] = 0.0
    return face_index, bary.astype(np.float32)


def index_image_impaint(
    index_image: np.ndarray,
    bary_image: Optional[np.ndarray] = None,
    distance_threshold: float = 100.0,
):
    """Fill empty texels from their nearest valid texel (scipy's Euclidean
    distance transform, which picks the same nearest texel as the JAX
    package's)."""
    from scipy import ndimage

    if index_image.ndim == 3:
        valid = (index_image != -1).any(axis=-1)
    else:
        valid = index_image != -1
    dist, (src_i, src_j) = ndimage.distance_transform_edt(
        ~valid, return_indices=True)
    fill = (~valid) & (dist < distance_threshold)
    out = index_image.copy()
    out[fill] = index_image[src_i[fill], src_j[fill]]
    if bary_image is not None:
        bout = bary_image.copy()
        bout[fill] = bary_image[src_i[fill], src_j[fill]]
        return out, bout
    return out


def compute_v2uv(n_verts: int, vi: np.ndarray, vti: np.ndarray, n_max: int = 4
                 ) -> np.ndarray:
    """Vertex index -> up to n_max texture-coordinate indices."""
    v2uv_dict: Dict[int, set] = {}
    for i_v, i_uv in zip(np.asarray(vi).reshape(-1),
                         np.asarray(vti).reshape(-1)):
        v2uv_dict.setdefault(int(i_v), set()).add(int(i_uv))
    v2uv = np.zeros((n_verts, n_max), dtype=np.int32)
    for i in range(n_verts):
        vals = sorted(v2uv_dict.get(i, {0}))
        v2uv[i, :] = vals[0]
        v2uv[i, : min(len(vals), n_max)] = np.array(vals)[:n_max]
    return v2uv


def compute_neighbours(n_verts: int, vi: np.ndarray, n_max_values: int = 10
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """First-ring neighbour indices/weights for Laplacian losses."""
    vi = np.asarray(vi)
    adj: Dict[int, set] = {i: set() for i in range(n_verts)}
    for face in vi:
        for idx in face:
            adj[int(idx)] |= set(int(x) for x in face) - {int(idx)}
    nbs_idxs = np.tile(np.arange(n_verts)[:, None], (1, n_max_values))
    nbs_weights = np.zeros((n_verts, n_max_values), dtype=np.float32)
    for idx in range(n_verts):
        n = min(len(adj[idx]), n_max_values)
        if n:
            nbs_idxs[idx, :n] = np.array(sorted(adj[idx]))[:n]
            nbs_weights[idx, :n] = -1.0 / n
    return nbs_idxs, nbs_weights


# ---------------------------------------------------------------------------
# device-side ops
# ---------------------------------------------------------------------------


def values_to_uv(values: torch.Tensor, index_img: torch.Tensor,
                 bary_img: torch.Tensor) -> torch.Tensor:
    """Per-vertex values [B, V, C] -> UV map [B, C, H, W] via bary blending.

    The three barycentric corners are gathered and summed in the JAX
    package's order, so the sums round alike."""
    idx_cf = index_img.permute(2, 0, 1).clamp(0, values.shape[1] - 1)
    bary_cf = bary_img.permute(2, 0, 1)                # [3, H, W]
    mask = (index_img != -1).all(dim=-1)               # [H, W]
    vt = values.transpose(1, 2)                        # [B, C, V]
    blended = None
    for k in range(3):
        term = vt[:, :, idx_cf[k]] * bary_cf[k][None, None]
        blended = term if blended is None else blended + term
    return blended * mask[None, None]


def sample_uv(
    values_uv: torch.Tensor,
    uv_coords: torch.Tensor,
    v2uv: Optional[torch.Tensor] = None,
    mode: str = "bilinear",
    align_corners: bool = True,
    flip_uvs: bool = False,
) -> torch.Tensor:
    """UV map [B, C, H, W] sampled at texcoords [T, 2] -> [B, T, C]."""
    B = values_uv.shape[0]
    if flip_uvs:
        uv_coords = torch.stack([uv_coords[:, 0], 1.0 - uv_coords[:, 1]], -1)
    grid = (uv_coords * 2.0 - 1.0)[None, :, None, :]  # [1, T, 1, 2]
    grid = grid.expand((B,) + grid.shape[1:])
    values = grid_sample(values_uv, grid, mode=mode,
                         align_corners=align_corners)
    values = values[..., 0].transpose(1, 2)  # [B, T, C]
    if v2uv is not None:
        values = values[:, v2uv].mean(dim=2)
    return values


def face_normals(v: torch.Tensor, vi: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    pts = v[:, vi]
    v0 = pts[:, :, 1] - pts[:, :, 0]
    v1 = pts[:, :, 2] - pts[:, :, 0]
    n = torch.linalg.cross(v0, v1)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + eps * eps)


def vert_normals(v: torch.Tensor, vi: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    """Vertex normals: the sum of the adjacent unit face normals."""
    fn = face_normals(v, vi)  # [B, F, 3]
    fn3 = fn[:, :, None].expand(-1, -1, 3, -1).reshape(fn.shape[0], -1, 3)
    vn = torch.zeros_like(v).index_add_(1, vi.reshape(-1), fn3)
    return vn / torch.sqrt(torch.sum(vn * vn, dim=-1, keepdim=True)
                           + eps * eps)


def compute_view_cos(verts: torch.Tensor, faces: torch.Tensor,
                     camera_pos: torch.Tensor) -> torch.Tensor:
    """Cosine between each vertex normal and the direction from the camera
    to the vertex: [B, V]."""
    vn = vert_normals(verts, faces)
    v2c = verts - camera_pos[:, None]
    v2c = v2c / torch.linalg.norm(v2c, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.einsum("bnd,bnd->bn", vn, v2c)


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
               ) -> torch.Tensor:
    """v / sqrt(|v|^2 + eps) along ``dim`` (eps inside the root, as in the
    JAX package)."""
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


def compute_tbn(geom: torch.Tensor, vt: torch.Tensor, vi: torch.Tensor,
                vti: torch.Tensor):
    """Per-face tangent, bitangent and normal from the mesh ``geom``
    [B, V, 3] and its texture coordinates, at the faces ``vi`` / ``vti``
    [..., 3]: three [B, ..., 3] tensors. A face of zero UV area divides by
    zero (inf, then NaN), as in the JAX package."""
    v0, v1, v2 = geom[:, vi[..., 0]], geom[:, vi[..., 1]], geom[:, vi[..., 2]]
    vt0, vt1, vt2 = vt[vti[..., 0]], vt[vti[..., 1]], vt[vti[..., 2]]
    v01, v02 = v1 - v0, v2 - v0
    vt01, vt02 = vt1 - vt0, vt2 - vt0
    f = 1.0 / (vt01[None, ..., 0] * vt02[None, ..., 1]
               - vt01[None, ..., 1] * vt02[None, ..., 0])
    tangent = f[..., None] * (
        v01 * vt02[None, ..., 1, None] - v02 * vt01[None, ..., 1, None])
    tangent = _normalize(tangent)
    normal = _normalize(torch.linalg.cross(v01, v02, dim=-1))
    bitangent = _normalize(torch.linalg.cross(tangent, normal, dim=-1))
    return tangent, bitangent, normal


def compute_tbn_uv(tri_xyz: torch.Tensor, tri_uv: torch.Tensor,
                   eps: float = 1e-5):
    """Tangent, bitangent and normal per texel from its triangle's gathered
    corners ``tri_xyz`` [B, N, 3, 3] and texture coordinates ``tri_uv``
    [N, 3, 2]: three [B, N, 3] tensors (``eps`` is unused, as in the JAX
    package)."""
    tri_uv = tri_uv[None]
    v01 = tri_xyz[:, :, 1] - tri_xyz[:, :, 0]
    v02 = tri_xyz[:, :, 2] - tri_xyz[:, :, 0]
    normal = _normalize(torch.linalg.cross(v01, v02, dim=-1))
    vt01 = tri_uv[:, :, 1] - tri_uv[:, :, 0]
    vt02 = tri_uv[:, :, 2] - tri_uv[:, :, 0]
    f = 1.0 / (vt01[..., 0] * vt02[..., 1] - vt01[..., 1] * vt02[..., 0])
    tangent = f[..., None] * (v01 * vt02[..., 1][..., None]
                              - v02 * vt01[..., 1][..., None])
    tangent = _normalize(tangent)
    bitangent = _normalize(torch.linalg.cross(normal, tangent, dim=-1))
    return tangent, bitangent, normal


def _clip_norm(v: torch.Tensor, eps: float) -> torch.Tensor:
    """v / max(|v|, eps) along the last axis, with ``jnp.clip``'s tie."""
    return v / clip(torch.linalg.norm(v, dim=-1, keepdim=True), eps,
                    float("inf"))


def compute_tbn_uv_given_normal(tri_xyz: torch.Tensor, tri_uv: torch.Tensor,
                                normals: torch.Tensor, eps: float = 1e-5):
    """The tangent frame of ``compute_tbn_uv`` orthogonalized against the
    given ``normals`` [B, N, 3]; UV areas under 1e-8 in magnitude count as
    1e-8."""
    tri_uv = tri_uv[None]
    v01 = tri_xyz[:, :, 1] - tri_xyz[:, :, 0]
    v02 = tri_xyz[:, :, 2] - tri_xyz[:, :, 0]
    vt01 = tri_uv[:, :, 1] - tri_uv[:, :, 0]
    vt02 = tri_uv[:, :, 2] - tri_uv[:, :, 0]
    fin = vt01[..., 0] * vt02[..., 1] - vt01[..., 1] * vt02[..., 0]
    fin = torch.where(fin.abs() < 1e-8, torch.full_like(fin, 1e-8), fin)
    f = 1.0 / fin
    tangents = f[..., None] * (v01 * vt02[..., 1][..., None]
                               - v02 * vt01[..., 1][..., None])
    tangents = _clip_norm(tangents, eps)
    bitangents = _clip_norm(torch.linalg.cross(normals, tangents, dim=-1),
                            eps)
    tangents = _clip_norm(torch.linalg.cross(bitangents, normals, dim=-1),
                          eps)
    return tangents, bitangents, normals


def make_postex(v: torch.Tensor, idxim: torch.Tensor, barim: torch.Tensor
                ) -> torch.Tensor:
    """Barycentric blend of the vertex positions ``v`` [B, V, 3] into a UV
    position map [B, 3, H, W] (``idxim`` [H, W, 3] vertex indices,
    ``barim`` [H, W, 3] weights)."""
    out = (barim[None, :, :, 0, None] * v[:, idxim[:, :, 0]]
           + barim[None, :, :, 1, None] * v[:, idxim[:, :, 1]]
           + barim[None, :, :, 2, None] * v[:, idxim[:, :, 2]])
    return out.permute(0, 3, 1, 2)


def convert_camera_parameters(Rt: torch.Tensor, K: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
    """World-to-camera ``Rt`` [B, 3, 4] and intrinsics ``K`` [B, 3, 3] ->
    the camera position, rotation, focal lengths and principal point."""
    R = Rt[:, :3, :3]
    t = -torch.einsum("bji,bj->bi", R, Rt[:, :3, 3])
    return dict(campos=t, camrot=R, focal=K[:, :2, :2], princpt=K[:, :2, 2])


def xyz2normals(xyz: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[B, 3, H, W] XYZ image -> normals by central differences."""
    pad = torch.nn.functional.pad(xyz, (1, 1, 1, 1))
    U = (pad[:, :, 2:, 1:-1] - pad[:, :, :-2, 1:-1]) / -2
    V = (pad[:, :, 1:-1, 2:] - pad[:, :, 1:-1, :-2]) / -2
    n = torch.linalg.cross(U, V, dim=1)
    return n / torch.linalg.norm(n, dim=1, keepdim=True).clamp(min=eps)


def project_points(p: torch.Tensor, Rt: torch.Tensor, K: torch.Tensor,
                   normalize: bool = False,
                   size: Optional[Tuple[int, int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole projection of p [B, N, 3] by Rt [B, 3, 4] and K [B, 3, 3]:
    (pixels [B, N, 2], depth [B, N]). Points behind the camera keep the
    sign of their depth in the division, as in the JAX package."""
    p_cam = torch.einsum("bij,bnj->bni", Rt[:, :3, :3], p) \
        + Rt[:, None, :3, 3]
    p_pix = torch.einsum("bij,bnj->bni", K, p_cam)
    depth = p_pix[..., 2:]
    pix = p_pix[..., :2] / depth.abs().clamp(min=1e-8) * torch.sign(depth)
    if normalize:
        h, w = size
        pix = 2.0 * pix / pix.new_tensor([w, h]) - 1.0
    return pix, depth[..., 0]


def project_points_multi(p: torch.Tensor, Rt: torch.Tensor, K: torch.Tensor,
                         normalize: bool = False,
                         size: Optional[Tuple[int, int]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-camera projection: p [B, N, 3], Rt [B, NC, 3, 4], K
    [B, NC, 3, 3] -> (pixels [B, NC, N, 2], depth [B, NC, N])."""
    p_cam = torch.einsum("bcij,bnj->bcni", Rt[..., :3, :3], p) \
        + Rt[:, :, None, :3, 3]
    p_pix = torch.einsum("bcij,bcnj->bcni", K, p_cam)
    depth = p_pix[..., 2:]
    pix = p_pix[..., :2] / depth.abs().clamp(min=1e-8) * torch.sign(depth)
    if normalize:
        h, w = size
        pix = 2.0 * pix / pix.new_tensor([w, h]) - 1.0
    return pix, depth[..., 0]


def depth2xyz(depth: torch.Tensor, focal: torch.Tensor,
              princpt: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] depth and intrinsics (focal [B, 2, 2], princpt [B, 2])
    -> camera-space XYZ [B, 3, H, W]."""
    _b, _, h, w = depth.shape
    ix = (torch.arange(w, dtype=depth.dtype, device=depth.device)[None, None]
          - princpt[:, None, None, 0]) / focal[:, None, None, 0, 0]
    iy = (torch.arange(h, dtype=depth.dtype, device=depth.device)[None, :,
                                                                  None]
          - princpt[:, None, None, 1]) / focal[:, None, None, 1, 1]
    return torch.stack([depth[:, 0] * ix, depth[:, 0] * iy, depth[:, 0]],
                       dim=1)


def depth2normals(depth: torch.Tensor, focal: torch.Tensor,
                  princpt: torch.Tensor) -> torch.Tensor:
    return xyz2normals(depth2xyz(depth, focal, princpt))


def depth_discontinuity_mask(depth: torch.Tensor, threshold: float = 40.0,
                             pool_ksize: int = 3) -> torch.Tensor:
    """Sobel-magnitude depth discontinuities of [B, 1, H, W] depth, dilated
    by a ``pool_ksize`` box (boolean [B, 1, H, W])."""
    kernel = torch.tensor(
        [[[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]],
         [[[-1, -2, -1], [0, 0, 0], [1, 2, 1]]]],
        dtype=depth.dtype, device=depth.device)
    g = torch.nn.functional.conv2d(depth, kernel, padding=1)
    disc = (torch.linalg.norm(g, dim=1, keepdim=True) > threshold).to(
        depth.dtype)
    pad = pool_ksize // 2
    pooled = torch.nn.functional.max_pool2d(disc, pool_ksize, stride=1,
                                            padding=pad)
    return pooled > 0.0


# ---------------------------------------------------------------------------
# GeometryModule
# ---------------------------------------------------------------------------


class GeometryModule:
    """UV <-> vertex transfer tables (the JAX package's utils/geom.py:441-497).

    The index and barycentric images are computed once on the host and
    kept on ``device`` as tensors. With ``impaint`` the empty texels within
    ``impaint_threshold`` texels of the layout take their nearest valid
    texel's entries."""

    def __init__(self, vi: np.ndarray, vt: np.ndarray, vti: np.ndarray,
                 v2uv: Optional[np.ndarray], uv_size: int,
                 flip_uv: bool = False, impaint: bool = False,
                 impaint_threshold: float = 100.0,
                 device: Union[str, torch.device] = "cuda"):
        device = resolve_device(device)
        self.uv_size = uv_size
        self.vi_np = np.asarray(vi, dtype=np.int64)
        self.vt_np = np.asarray(vt, dtype=np.float32)
        self.vti_np = np.asarray(vti, dtype=np.int64)
        index_image = make_uv_vert_index(self.vt_np, self.vi_np, self.vti_np,
                                         uv_size=uv_size, flip_uv=flip_uv)
        face_index, bary_image = make_uv_barys(self.vt_np, self.vti_np,
                                               uv_size=uv_size,
                                               flip_uv=flip_uv)
        if impaint:
            index_image, bary_image = index_image_impaint(
                index_image, bary_image, impaint_threshold)
            face_index = index_image_impaint(
                face_index, distance_threshold=impaint_threshold)
        self.index_image_np = index_image
        self.bary_image_np = bary_image
        self.face_index_image_np = face_index
        self.vi = torch.from_numpy(self.vi_np).to(device)
        self.vt = torch.from_numpy(self.vt_np).to(device)
        self.index_image = torch.from_numpy(index_image).to(device)
        self.bary_image = torch.from_numpy(bary_image).to(device)
        self.v2uv = (None if v2uv is None else
                     torch.from_numpy(np.asarray(v2uv, np.int64)).to(device))

    def vn(self, verts: torch.Tensor) -> torch.Tensor:
        return vert_normals(verts, self.vi)

    def to_uv(self, values: torch.Tensor) -> torch.Tensor:
        return values_to_uv(values, self.index_image, self.bary_image)

    def from_uv(self, values_uv: torch.Tensor) -> torch.Tensor:
        return sample_uv(values_uv, self.vt, self.v2uv)


# ---------------------------------------------------------------------------
# view-texture unprojection (the JAX package's utils/geom.py:505-572)
# ---------------------------------------------------------------------------


def compute_face_visibility(index_img: torch.Tensor, n_faces: int
                            ) -> torch.Tensor:
    """[B, H, W] rasterized face ids -> [B, F] visibility (scatter-max)."""
    B = index_img.shape[0]
    flat = index_img.reshape(B, -1)
    valid = (flat != -1).to(torch.float32)
    fi = flat.clamp(0, n_faces - 1).long()
    mask = torch.zeros((B, n_faces), device=index_img.device)
    mask.scatter_reduce_(1, fi, valid, "amax")
    return mask > 0


def compute_uv_visibility_face(face_index_image: torch.Tensor, n_faces: int,
                               face_index_uv: torch.Tensor) -> torch.Tensor:
    """Per-texel visibility [B, T, T] from per-pixel rasterized face ids."""
    face_mask = compute_face_visibility(face_index_image, n_faces)  # [B, F]
    fi = face_index_uv.clamp(0, n_faces - 1).long()
    return face_mask[:, fi] & (face_index_uv != -1)[None]


def compute_view_texture(
    verts: torch.Tensor,             # [B, V, 3]
    faces: torch.Tensor,             # [F, 3]
    image: torch.Tensor,             # [B, 3, H, W]
    face_index_image: torch.Tensor,  # [B, H, W] rasterized face ids
    normal_image,                    # unused (parity with the reference)
    K: torch.Tensor,                 # [B, 3, 3]
    Rt: torch.Tensor,                # [B, 3, 4]
    index_image_uv: torch.Tensor,    # [T, T, 3]
    bary_image_uv: torch.Tensor,     # [T, T, 3]
    face_index_uv: torch.Tensor,     # [T, T]
    intensity_threshold=None,
    normal_threshold=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject a camera image into UV space with face-visibility masking:
    each texel's surface point is projected into the image and takes its
    nearest pixel. Returns (tex [B, 3, T, T], visibility [B, 1, T, T])."""
    B = verts.shape[0]
    T = index_image_uv.shape[0]
    H, W = image.shape[2:4]

    uv_mask = index_image_uv[..., 0] != -1
    idx = index_image_uv.clamp(0, verts.shape[1] - 1).long()   # [T, T, 3]
    corners = verts[:, idx] * bary_image_uv[None, ..., None]   # [B, T, T, 3, 3]
    xyz_w = corners[..., 0, :] + corners[..., 1, :] + corners[..., 2, :]
    v_pix, _ = project_points(xyz_w.reshape(B, -1, 3), Rt, K)
    yxs = 2.0 * torch.stack(
        [v_pix[..., 0] / W, v_pix[..., 1] / H], dim=-1) - 1.0
    verts_rgb = grid_sample(
        image, yxs.reshape(B, T, T, 2), mode="nearest",
        align_corners=False, padding_mode="border")           # [B, 3, T, T]
    tex = verts_rgb * uv_mask[None, None]

    visibility = compute_uv_visibility_face(
        face_index_image, faces.shape[0], face_index_uv)
    tex = tex * visibility[:, None]
    if intensity_threshold:
        tex = tex * (tex <= intensity_threshold).all(dim=1, keepdim=True)
    return tex, visibility[:, None]
