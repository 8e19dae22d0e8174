"""Quaternion / rotation maths, (x, y, z, w) layout.

Port of ``wiki_grx_gym_tpu/utils/maths.py`` (itself mirroring IsaacGym's
``torch_utils.py`` and legged_gym's ``utils/math.py``). Every function
broadcasts over leading batch dimensions. Random draws take an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-9


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` for (..., 3) vectors (same formula, same rounding)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unit-normalize along ``dim`` (guarding the zero vector)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=_EPS)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_identity(batch_shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x, y, z, w) quaternions."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q``."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


quat_rotate = quat_apply


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of ``q``."""
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """``axis`` need not be unit length."""
    axis = normalize(axis)
    half = 0.5 * angle
    s = torch.sin(half)
    xyz = axis * s[..., None]
    w = torch.cos(half)[..., None]
    return torch.cat([xyz, w], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler angles -> quat."""
    cy = torch.cos(yaw * 0.5)
    sy = torch.sin(yaw * 0.5)
    cr = torch.cos(roll * 0.5)
    sr = torch.sin(roll * 0.5)
    cp = torch.cos(pitch * 0.5)
    sp = torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz(q: torch.Tensor):
    """Quat -> (roll, pitch, yaw)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the yaw component of ``q``."""
    q_yaw = q.clone()
    q_yaw[..., 0] = 0.0
    q_yaw[..., 1] = 0.0
    return quat_apply(quat_unit(q_yaw), v)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: mod 2pi, then subtract 2pi where > pi."""
    a = torch.remainder(angle, 2.0 * math.pi)
    return a - 2.0 * math.pi * (a > math.pi)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quat (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by a world-frame angular velocity over ``dt``
    (exact exponential map)."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1)
    axis = omega_world / torch.clamp(angle, min=_EPS)[..., None]
    dq = quat_from_angle_axis(angle * dt, axis)
    return quat_unit(quat_mul(dq, q))


def uniform(generator: torch.Generator, lo, hi, shape, device=None) -> torch.Tensor:
    """Uniform sample in [lo, hi)."""
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return lo + u * (hi - lo)


def sample_distribution(generator: torch.Generator, rng, shape, distribution="uniform",
                        device=None) -> torch.Tensor:
    """Domain-randomization sampler:

    - ``uniform``: ``rng = (lo, hi)`` -> U[lo, hi);
    - ``loguniform``: ``rng = (lo, hi)``, both > 0 -> exp(U[ln lo, ln hi));
    - ``gaussian``: ``rng = (mu, var)`` -> N(mu, sqrt(var)).
    """
    lo, hi = float(rng[0]), float(rng[1])
    if distribution == "uniform":
        return uniform(generator, lo, hi, shape, device)
    if distribution == "loguniform":
        assert lo > 0.0 and hi > 0.0, "loguniform needs a positive range"
        return torch.exp(uniform(generator, float(np.log(lo)), float(np.log(hi)), shape, device))
    if distribution == "gaussian":
        z = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
        return lo + math.sqrt(hi) * z
    raise ValueError(f"unknown DR distribution {distribution!r}")
