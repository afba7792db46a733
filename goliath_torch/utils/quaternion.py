"""Quaternion algebra (port of the JAX package's utils/quaternion.py).

Quaternions are stored (x, y, z, w), matching the reference. Only what the
ported paths use is here so far (the products, rotation and Euler angles of
the skeleton solve, ``utils/lbs.py``); the rest of the JAX module
(matrix -> quaternion, Rodrigues, rigid alignment) comes with the paths
that use it.
"""

from __future__ import annotations

import torch


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
