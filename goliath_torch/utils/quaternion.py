"""Quaternion algebra (port of the JAX package's utils/quaternion.py).

Quaternions are stored (x, y, z, w), matching the reference. Only what the
ported paths use is here so far: the products, rotation and Euler angles of
the skeleton solve (``utils/lbs.py``), and matrix -> quaternion and the
Rodrigues maps of URHand's pose conditioning (``models/urhand.py``), and
the weighted Kabsch alignment ``rigid_align``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from goliath_torch.utils.image import clip


def quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x,y,z,w) quaternions, broadcasting over batch."""
    qx, qy, qz, qw = q.unbind(-1)
    rx, ry, rz, rw = r.unbind(-1)
    return torch.stack(
        [
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
            qw * rw - qx * rx - qy * ry - qz * rz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    return quat_conj(q) / torch.sum(q * q, dim=-1, keepdim=True).clamp(
        min=1e-20)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qvec = q[..., :3]
    qw = q[..., 3:4]
    qvec, v = torch.broadcast_tensors(qvec, v)
    t = 2.0 * torch.linalg.cross(qvec, v)
    return v + qw * t + torch.linalg.cross(qvec, t)


def quat_from_xyz(xyz: torch.Tensor) -> torch.Tensor:
    """Euler XYZ (intrinsic, radians) -> quaternion (x,y,z,w)."""
    half = 0.5 * xyz
    cx, cy, cz = torch.cos(half).unbind(-1)
    sx, sy, sz = torch.sin(half).unbind(-1)
    # q = qz * qy * qx (apply x first)
    return torch.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dim=-1,
    )


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x,y,z,w) [..., 4] -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=dim, keepdim=True).clamp(min=eps)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (x,y,z,w).

    Branch-free: all four classic cases are evaluated and selected per
    matrix, as in the JAX package."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp(min=1e-12))

    # case 0: trace positive
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                      0.25 * s0], -1)
    # case 1: m00 largest
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    # case 2: m11 largest
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    # case 3: m22 largest
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)

    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    q_rest = torch.where(c1[..., None], q1,
                         torch.where(c2[..., None], q2, q3))
    q = torch.where((tr > 0.0)[..., None], q0, q_rest)
    return normalize(q)


def axisangle_to_matrix(rvec: torch.Tensor, eps: float = 1e-10
                        ) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]. eps
    goes inside the sqrt, so the gradient at a zero rvec is finite."""
    theta = torch.sqrt(torch.sum(rvec * rvec, dim=-1, keepdim=True) + eps)
    axis = rvec / theta
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1)
    K = K.reshape(K.shape[:-1] + (3, 3))
    th_ = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + torch.sin(th_) * K + (1.0 - torch.cos(th_)) * (K @ K)


def matrix_to_axisangle(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse Rodrigues through the quaternion (stable near theta = pi)."""
    q = matrix_to_quat(R)
    qvec = q[..., :3]
    qw = q[..., 3]
    n = torch.linalg.norm(qvec, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    axis = qvec / n.clamp(min=eps)[..., None]
    return axis * theta[..., None]


def rigid_align(src: torch.Tensor, tgt: torch.Tensor,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Kabsch: (R, t) minimizing sum w |R src + t - tgt|^2.

    src, tgt: [..., N, 3]; weights [..., N] (all ones when not given).
    Returns R [..., 3, 3] (a rotation: det +1) and t [..., 3]."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights[..., None] / clip(
        torch.sum(weights, dim=-1, keepdim=True)[..., None], 1e-12,
        float("inf"))
    mu_s = torch.sum(w * src, dim=-2, keepdim=True)
    mu_t = torch.sum(w * tgt, dim=-2, keepdim=True)
    cov = torch.einsum("...ni,...nj->...ij", w * (tgt - mu_t), src - mu_s)
    U, _, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    D = torch.diag_embed(torch.stack([ones, ones, det], dim=-1))
    R = U @ D @ Vt
    t = mu_t[..., 0, :] - torch.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return R, t
