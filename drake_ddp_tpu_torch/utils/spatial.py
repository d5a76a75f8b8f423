"""Rotation and quaternion helpers (wxyz convention, matching Drake's
floating-base state layout: q = [qw qx qy qz, px py pz]).

Port of ``drake_ddp_tpu/utils/spatial.py``.  The tensor functions take
any leading batch dimensions (the vector or quaternion on the last
axis) and compute on their input's device and dtype; ``rpy_to_rot`` is a
host-side numpy helper for model building.
"""

from __future__ import annotations

import numpy as np
import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: hat(v) @ u == cross(v, u)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
    ], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion product a * b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_integrate(q: torch.Tensor, w_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a quaternion by a world-frame angular velocity:
    q' = normalize(q + dt * 0.5 * [0, w] * q) (Drake's qdot = N(q) v for
    a quaternion floating base)."""
    wq = torch.cat([torch.zeros_like(w_world[..., :1]), w_world], dim=-1)
    q_new = q + dt * (0.5 * quat_mul(wq, q))
    return q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)


def axis_angle_rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (constant unit) axis."""
    K = hat(axis)
    s, c = torch.sin(angle), torch.cos(angle)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s[..., None, None] * K + (1 - c)[..., None, None] * (K @ K)


def rpy_to_rot(rpy) -> np.ndarray:
    """URDF roll-pitch-yaw (extrinsic XYZ) -> rotation matrix (host)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
