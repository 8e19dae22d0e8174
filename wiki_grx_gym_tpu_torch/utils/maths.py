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


def _div(a, c: float):
    """``a / c`` for a Python float ``c``, a true division on every device.
    PyTorch on CUDA turns a division by a Python scalar into a
    multiplication by the scalar's float32 reciprocal, which can round to
    the neighbouring value; a 0-d tensor divisor keeps the division (the
    kernel's and the CPU's)."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quat (x, y, z, w). Branchless Shepperd-style blend."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(w2x4, x, y, z, w):
        s = torch.sqrt(torch.clamp(w2x4, min=_EPS)) * 2.0
        return torch.stack([x / s, y / s, z / s, w / s], dim=-1)

    q0 = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, (1.0 + tr) / 1.0)
    q1 = cand(1.0 + m00 - m11 - m22, (1.0 + m00 - m11 - m22), m01 + m10, m02 + m20, m21 - m12)
    q2 = cand(1.0 - m00 + m11 - m22, m01 + m10, (1.0 - m00 + m11 - m22), m12 + m21, m02 - m20)
    q3 = cand(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21, (1.0 - m00 - m11 + m22), m10 - m01)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_unit(q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix, shape ``(..., 3, 3)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# component-form small-matrix products: the same sums in the same order as
# the JAX package's (each entry a + b + c of elementwise products)

def mat3_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3)."""
    return torch.stack(
        [
            m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1] + m[..., 0, 2] * v[..., 2],
            m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1] + m[..., 1, 2] * v[..., 2],
            m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1] + m[..., 2, 2] * v[..., 2],
        ],
        dim=-1,
    )


def mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3)."""
    rows = []
    for i in range(3):
        rows.append(torch.stack([
            a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j] + a[..., i, 2] * b[..., 2, j]
            for j in range(3)
        ], dim=-1))
    return torch.stack(rows, dim=-2)


def mat3_sandwich(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """R @ M @ R^T."""
    rm = mat3_mul(r, m)
    rows = []
    for i in range(3):
        rows.append(torch.stack([
            rm[..., i, 0] * r[..., j, 0] + rm[..., i, 1] * r[..., j, 1] + rm[..., i, 2] * r[..., j, 2]
            for j in range(3)
        ], dim=-1))
    return torch.stack(rows, dim=-2)


def outer3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) outer (..., 3) -> (..., 3, 3)."""
    return a[..., :, None] * b[..., None, :]


def sqrt_uniform_shape(r: torch.Tensor, lo, hi) -> torch.Tensor:
    """Map U[-1, 1) draws ``r`` to the signed-sqrt-shaped sample of
    :func:`rand_sqrt_uniform`."""
    r = torch.where(r < 0.0, -torch.sqrt(-r), torch.sqrt(r))
    return (r + 1.0) / 2.0 * (hi - lo) + lo


def rand_sqrt_uniform(generator: torch.Generator, lo, hi, shape, device=None) -> torch.Tensor:
    """Signed-sqrt-shaped uniform in [lo, hi) (legged_gym utils/math.py:51-56)."""
    return sqrt_uniform_shape(uniform(generator, -1.0, 1.0, shape, device), lo, hi)


def tensor_clamp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Elementwise clamp with tensor bounds (torch_utils.py:207-209)."""
    return torch.clamp(x, lo, hi)
