"""Mesh rasterizer (port of the JAX package's ops/rasterizer.py, forward).

* ``transform``: world -> pixel-space verts (x_pix, y_pix, z_cam).
* ``rasterize``: per-pixel face index. Faces are binned to screen tiles by
  ``bin_to_tiles`` (ops/binning.py, prefix sums on K4) and the z-buffer is
  K5 (ops/rasterizer_cuda.py: the kernel on CUDA tensors, its plain version
  on CPU tensors). It returns indices and takes no gradient.
* ``render_barys``: screen-space barycentrics and perspective-correct depth
  at the rasterized faces, differentiable with respect to the vertices.
* ``interpolate``: barycentric blend of per-vertex attributes.
* ``edge_grad_estimator``: the identity on the image in the forward; its
  backward adds the silhouette gradients of neighbouring pixel pairs that
  lie on different faces to the screen-space x and y of the front face's
  vertices (``edge_grads``, plain PyTorch as in the JAX package, whose
  backward is XLA outside any Pallas kernel).
* ``rasterize_reference``: the exact per-pixel, all-faces oracle.
* ``RenderLayer``: the facade the models call, one sample at a time.

K5 follows the window of the TPU kernel (the JAX package's
``use_pallas=True`` path), not that of its XLA scan, which the JAX package
takes off the TPU; they differ only in tiles with more than
``max_faces_per_tile`` faces (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.binning import bin_to_tiles
from goliath_torch.ops.rasterizer_cuda import BIG_DEPTH, pack_face_rows, \
    zbuffer
from goliath_torch.utils.sampling import grid_sample


def transform(verts: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor
              ) -> torch.Tensor:
    """[B, V, 3] world verts -> [B, V, 3] (x_pix, y_pix, z_cam)."""
    v_cam = torch.einsum("bij,bnj->bni", Rt[:, :3, :3], verts) \
        + Rt[:, None, :3, 3]
    z = v_cam[..., 2:3]
    zs = torch.where(z.abs() < 1e-8, 1e-8, z)
    xy = torch.einsum("bij,bnj->bni", K[:, :2, :2], v_cam[..., :2] / zs) \
        + K[:, None, :2, 2]
    return torch.cat([xy, v_cam[..., 2:3]], dim=-1)


def _edge_coeffs(tri: torch.Tensor):
    """Edge-function coefficients of faces tri [F, 3, 2] (screen xy):
    (a, b, c) each [F, 3] with E_k(p) = a_k px + b_k py + c_k, and the
    signed area [F]."""
    x, y = tri[..., 0], tri[..., 1]
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], -1)
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], -1)
    c = torch.stack(
        [x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0], -1)
    area = x1 * y2 - x2 * y1 - (x0 * y2 - x2 * y0) + x0 * y1 - x1 * y0
    return a, b, c, area


def _face_rows(v_pix: torch.Tensor, vi: torch.Tensor, z_near: float):
    """Per-face z-buffer inputs: normalized edge coefficients, |1/area|,
    1/z per corner, validity and the screen bounding box."""
    tri = v_pix[vi]                                    # [F, 3, 3]
    z = tri[..., 2]
    valid = (z > z_near).all(dim=-1)
    a, b, c, area = _edge_coeffs(tri[..., :2])
    valid = valid & (area.abs() > 1e-12)
    # edge functions positive inside whatever the winding
    sgn = torch.sign(area)[:, None]
    inv_area = 1.0 / torch.where(area.abs() < 1e-12, 1e-12, area)
    inv_z = 1.0 / z.clamp(min=z_near)                  # perspective 1/z
    return (a * sgn, b * sgn, c * sgn, inv_area, inv_z, valid,
            tri[..., :2].amin(dim=1), tri[..., :2].amax(dim=1))


@torch.no_grad()
def bin_faces(v_pix: torch.Tensor, vi: torch.Tensor, img_h: int, img_w: int,
              tile_size: int = 16, max_tiles_per_face: int = 64,
              pair_budget_mult: int = 8, z_near: float = 1e-4):
    """The z-buffer's inputs for one image's v_pix [V, 3]: the face rows
    [budget, 16] in sorted-pair order and the tile binning (K4 on the
    card)."""
    ntx = -(-img_w // tile_size)
    nty = -(-img_h // tile_size)
    an, bn, cn, inv_area, inv_z, valid, xy_min, xy_max = _face_rows(
        v_pix, vi, z_near)
    t_min = torch.floor(xy_min / tile_size).to(torch.int32)
    t_max = (torch.floor(xy_max / tile_size) + 1).to(torch.int32)
    binning = bin_to_tiles(t_min, t_max, valid, ntx, nty, max_tiles_per_face,
                           pair_budget_mult * vi.shape[0])
    rows = pack_face_rows(an, bn, cn, inv_area.abs(), inv_z,
                          valid.to(an.dtype), binning.sorted_prim)
    return rows, binning


def rasterize(v_pix: torch.Tensor, vi: torch.Tensor, img_h: int, img_w: int,
              tile_size: int = 16, max_tiles_per_face: int = 64,
              max_faces_per_tile: int = 256, chunk: int = 32,
              pair_budget_mult: int = 8, z_near: float = 1e-4
              ) -> torch.Tensor:
    """Per-pixel face index image [H, W] int32, -1 where empty, of one
    image's v_pix [V, 3]."""
    rows, b = bin_faces(v_pix, vi, img_h, img_w, tile_size,
                        max_tiles_per_face, pair_budget_mult, z_near)
    index_img, _ = zbuffer(rows, b.sorted_prim, b.tile_start, b.tile_end,
                           img_h, img_w, tile_size, b.num_tiles_x,
                           b.num_tiles_y, chunk, max_faces_per_tile)
    return index_img


def render_barys(v_pix: torch.Tensor, vi: torch.Tensor,
                 index_img: torch.Tensor, z_near: float = 1e-4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth_img [H, W], bary_img [3, H, W]), differentiable with respect
    to v_pix: screen-space barycentrics at the pixel centres of the
    rasterized faces; depth is perspective-correct (1 / interp(1/z))."""
    H, W = index_img.shape
    fi = index_img.clamp(0, vi.shape[0] - 1).long()
    vt3 = v_pix.T                                      # [3, V]
    p0 = vt3[:, vi[:, 0][fi]]                          # [3, H, W]
    p1 = vt3[:, vi[:, 1][fi]]
    p2 = vt3[:, vi[:, 2][fi]]
    x0, x1, x2 = p0[0], p1[0], p2[0]
    y0, y1, y2 = p0[1], p1[1], p2[1]
    py, px = torch.meshgrid(
        torch.arange(H, dtype=v_pix.dtype, device=v_pix.device) + 0.5,
        torch.arange(W, dtype=v_pix.dtype, device=v_pix.device) + 0.5,
        indexing="ij")
    e0 = (y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)
    e1 = (y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)
    e2 = (y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)
    area = x1 * y2 - x2 * y1 - (x0 * y2 - x2 * y0) + x0 * y1 - x1 * y0
    inv_area = 1.0 / torch.where(area.abs() < 1e-12, 1e-12, area)
    bary = torch.stack([e0, e1, e2], dim=0) * inv_area[None]
    mask = index_img != -1
    bary = bary * mask[None]
    izp = (bary[0] / p0[2].clamp(min=z_near)
           + bary[1] / p1[2].clamp(min=z_near)
           + bary[2] / p2[2].clamp(min=z_near))
    depth = torch.where(mask, 1.0 / izp.clamp(min=1e-12), 0.0)
    return depth, bary


def interpolate(vert_attrs: torch.Tensor, vi: torch.Tensor,
                index_img: torch.Tensor, bary_img: torch.Tensor
                ) -> torch.Tensor:
    """[C, H, W] barycentric blend of vert_attrs [V, C] (zeros at empty
    pixels), one corner at a time as in the JAX package."""
    fi = index_img.clamp(0, vi.shape[0] - 1).long()
    at = vert_attrs.T                                  # [C, V]
    out = None
    for k in range(3):
        term = at[:, vi[:, k][fi]] * bary_img[k][None]
        out = term if out is None else out + term
    return out * (index_img != -1)[None]


def _pair_grads(g, img, vi, bary_img, index_img, depth_or_big, V: int,
                dim: int) -> torch.Tensor:
    """Silhouette gradient of every pixel pair that neighbours along ``dim``
    (-1: x, -2: y) of a batch, scattered into the x (or y) of the front
    face's vertices: [B * (V + 1)], sample b's vertex v at b * (V + 1) + v
    and its drop slot at b * (V + 1) + V."""
    n = index_img.shape[dim]

    def a(x):
        return x.narrow(dim, 0, n - 1)

    def b(x):
        return x.narrow(dim, 1, n - 1)

    fa, fb = a(index_img), b(index_img)
    boundary = fa != fb
    a_front = a(depth_or_big) < b(depth_or_big)   # pixel a's face occludes
    img_a, img_b, g_a, g_b = a(img), b(img), a(g), b(g)
    # moving the boundary toward the back pixel replaces back color with
    # front color there: dL/dpos = <g_back, img_front - img_back>
    dl_front = torch.where(a_front, (g_b * (img_a - img_b)).sum(1),
                           -(g_a * (img_b - img_a)).sum(1))
    dl_front = torch.where(boundary, dl_front, 0.0)
    front_face = torch.where(a_front, fa, fb)                # [B, h, w]
    front_bary = torch.where(a_front[:, None], a(bary_img), b(bary_img))
    contrib = front_bary * dl_front[:, None]                 # [B, 3, h, w]
    vids = vi[front_face.clamp(0, vi.shape[0] - 1).long()]   # [B, h, w, 3]
    ok = boundary & (front_face >= 0)
    vids = torch.where(ok[:, None], vids.permute(0, 3, 1, 2), V)
    base = torch.arange(vids.shape[0], device=vids.device) * (V + 1)
    acc = torch.zeros(vids.shape[0] * (V + 1), dtype=contrib.dtype,
                      device=contrib.device)
    return acc.index_add_(0, (vids + base[:, None, None, None]).reshape(-1),
                          contrib.reshape(-1))


def edge_grads(g: torch.Tensor, img: torch.Tensor, vi: torch.Tensor,
               bary_img: torch.Tensor, index_img: torch.Tensor,
               depth_img: torch.Tensor, n_verts: int) -> torch.Tensor:
    """The edge-gradient estimator's gradient with respect to v_pix
    [B, V, 3] (x and y; z is 0) for the image gradient ``g`` [B, C, H, W]
    (the JAX package's ``_eg_bwd``, per sample there). A pixel pair on
    different faces gives its front face's vertices (the pixel of the
    smaller depth, background at BIG_DEPTH, ties to the second pixel) the
    front face's barycentrics times <g_back, img_front - img_back>; pairs
    on one face, or whose front is the background, give nothing.
    ``index_add_`` sums in the order of the pairs on the CPU and
    atomically (in no fixed order) on the card."""
    depth_or_big = torch.where(index_img != -1, depth_img, BIG_DEPTH)
    B, V = img.shape[0], n_verts
    gx, gy = (_pair_grads(g, img, vi, bary_img, index_img, depth_or_big, V,
                          dim).view(B, V + 1)[:, :V] for dim in (-1, -2))
    return torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1)


class EdgeGradEstimator(torch.autograd.Function):
    """The identity on the image; its backward passes the image gradient
    through and adds the silhouette gradients (``edge_grads``) to v_pix.
    Nothing flows to the barycentrics, the face index or the depth."""

    @staticmethod
    def forward(ctx, v_pix, vi, bary_img, img, index_img, depth_img):
        ctx.save_for_backward(vi, bary_img, img, index_img, depth_img)
        ctx.n_verts = v_pix.shape[-2]
        return img.view_as(img)

    @staticmethod
    def backward(ctx, g):
        vi, bary_img, img, index_img, depth_img = ctx.saved_tensors
        return (edge_grads(g, img, vi, bary_img, index_img, depth_img,
                           ctx.n_verts), None, None, g, None, None)


def edge_grad_estimator(v_pix, vi, bary_img, img, index_img, depth_img):
    """The image ``img`` [B, C, H, W], through which the backward passes
    silhouette gradients to ``v_pix`` [B, V, 3] (``bary_img`` [B, 3, H, W],
    ``index_img`` and ``depth_img`` [B, H, W]; the JAX package maps its
    per-sample estimator over the batch)."""
    return EdgeGradEstimator.apply(v_pix, vi, bary_img, img, index_img,
                                   depth_img)


def rasterize_reference(v_pix: torch.Tensor, vi: torch.Tensor, img_h: int,
                        img_w: int, z_near: float = 1e-4) -> torch.Tensor:
    """O(H*W*F) z-buffer over every face; small inputs only."""
    an, bn, cn, inv_area, inv_z, valid, _, _ = _face_rows(v_pix, vi, z_near)
    py, px = torch.meshgrid(
        torch.arange(img_h, dtype=v_pix.dtype, device=v_pix.device) + 0.5,
        torch.arange(img_w, dtype=v_pix.dtype, device=v_pix.device) + 0.5,
        indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)     # [P, 2]
    E = (an[:, :, None] * pix[None, None, :, 0]
         + bn[:, :, None] * pix[None, None, :, 1]
         + cn[:, :, None])                             # [F, 3, P]
    inside = (E >= 0).all(dim=1) & valid[:, None]
    bary = E * inv_area.abs()[:, None, None]
    izp = torch.einsum("fcp,fc->fp", bary, inv_z)
    zp = torch.where(inside, 1.0 / izp.clamp(min=1e-12), BIG_DEPTH)
    zmin, best = zp.min(dim=0)
    idx = torch.where(zmin < BIG_DEPTH, best, -1)
    return idx.reshape(img_h, img_w).to(torch.int32)


class RenderLayer:
    """Rasterize, interpolate texture coordinates and sample a texture, for
    a batch of meshes of one topology. Tables live on ``device``."""

    def __init__(self, h: int, w: int, vi, vt, vti, flip_uvs: bool = False,
                 device: torch.device | str = "cuda", **raster_kwargs):
        device = resolve_device(device)
        self.h, self.w = h, w
        self.vi = torch.from_numpy(np.asarray(vi, np.int64)).to(device)
        vt = np.asarray(vt, np.float32).copy()
        if flip_uvs:
            vt[:, 1] = 1.0 - vt[:, 1]
        self.vt = torch.from_numpy(vt).to(device)
        self.vti = torch.from_numpy(np.asarray(vti, np.int64)).to(device)
        self.raster_kwargs = raster_kwargs

    def __call__(self, verts: torch.Tensor, tex: torch.Tensor,
                 K: torch.Tensor, Rt: torch.Tensor, edge_grad: bool = True
                 ) -> Dict[str, torch.Tensor]:
        """verts [B, V, 3], tex [B, C, Ht, Wt] -> ``render`` [B, C, H, W]
        and the rasterizer's images (depth, barycentrics, face index,
        texture coordinates, coverage mask)."""
        v_pix = transform(verts, K, Rt)
        index_img = torch.stack([
            rasterize(vp, self.vi, self.h, self.w, **self.raster_kwargs)
            for vp in v_pix])                          # [B, H, W]
        depth_img, bary_img = [], []
        for vp, ii in zip(v_pix, index_img):
            d, b = render_barys(vp, self.vi, ii)
            depth_img.append(d)
            bary_img.append(b)
        depth_img, bary_img = torch.stack(depth_img), torch.stack(bary_img)
        vt_attr = self.vt * 2.0 - 1.0
        vt_img = torch.stack([
            interpolate(vt_attr, self.vti, ii, bb)
            for ii, bb in zip(index_img, bary_img)])   # [B, 2, H, W]
        mask = (index_img != -1)[:, None].to(tex.dtype)
        img = grid_sample(tex, vt_img.permute(0, 2, 3, 1), mode="bilinear",
                          align_corners=False) * mask
        if edge_grad:
            img = edge_grad_estimator(v_pix, self.vi, bary_img, img,
                                      index_img, depth_img)
        return {
            "render": img,
            "depth_img": depth_img,
            "v_pix": v_pix,
            "vt_img": vt_img,
            "index_img": index_img,
            "bary_img": bary_img,
            "mask": mask,
        }
