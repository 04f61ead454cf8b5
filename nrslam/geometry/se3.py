"""Batched SE(3) Lie-group operations on (quaternion, translation) pairs.

JAX replacement for the Sophus::SE3f algebra used throughout the
reference (e.g. /root/reference/modules/map/frame.h:117). All functions
broadcast over leading batch dimensions and are jit/vmap/grad friendly.

Conventions:
- Quaternions are stored as ``[w, x, y, z]`` (Hamilton, unit norm).
- ``SE3`` represents a rigid transform ``X -> R @ X + t``.
- Twists are 6-vectors ``[omega, v]`` (rotation first), matching the g2o
  ``SE3Quat::exp`` ordering used by the reference's pose vertices
  (/root/reference/modules/optimization/reprojection_error.cc:51-58 builds the
  3x6 expmap Jacobian with the skew block in columns 0-2 and identity in
  columns 3-5, and g2o applies updates as ``T <- exp(delta) * T``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SE3(NamedTuple):
    """Rigid transform as unit quaternion [..., 4] (wxyz) + translation [..., 3]."""

    q: jnp.ndarray
    t: jnp.ndarray

    @property
    def batch_shape(self):
        return self.t.shape[:-1]


def identity(batch_shape=(), dtype=jnp.float32) -> SE3:
    q = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0, 0.0], dtype), batch_shape + (4,))
    t = jnp.zeros(batch_shape + (3,), dtype)
    return SE3(q, t)


# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------

def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of wxyz quaternions, broadcasting over leading dims."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v`` [..., 3] by quaternions ``q`` [..., 4].

    Uses the expanded form ``v + 2*w*(u x v) + 2*(u x (u x v))`` which is
    cheaper than two Hamilton products and fully vectorized.
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    # Four candidate constructions; pick the best-conditioned one.
    qw = jnp.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)

    traces = jnp.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
         1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = jnp.argmax(traces, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign (w >= 0).
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_slerp(q0: jnp.ndarray, q1: jnp.ndarray, u) -> jnp.ndarray:
    """Spherical interpolation between unit quaternions (shortest arc)."""
    u = jnp.asarray(u)[..., None]
    d = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    # Fall back to lerp when nearly parallel.
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    near = sin_theta < 1e-6
    w0 = jnp.where(near, 1.0 - u, jnp.sin((1.0 - u) * theta) / jnp.where(near, 1.0, sin_theta))
    w1 = jnp.where(near, u, jnp.sin(u * theta) / jnp.where(near, 1.0, sin_theta))
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# SE(3) group operations
# ---------------------------------------------------------------------------

def compose(a: SE3, b: SE3) -> SE3:
    """a * b (apply b first, then a)."""
    return SE3(quat_normalize(quat_multiply(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(T: SE3) -> SE3:
    qinv = quat_conjugate(T.q)
    return SE3(qinv, -quat_rotate(qinv, T.t))


def apply(T: SE3, X: jnp.ndarray) -> jnp.ndarray:
    """Transform points X [..., 3]."""
    return quat_rotate(T.q, X) + T.t


def to_matrix(T: SE3) -> jnp.ndarray:
    R = quat_to_matrix(T.q)
    top = jnp.concatenate([R, T.t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], R.dtype), T.t.shape[:-1] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(M: jnp.ndarray) -> SE3:
    return SE3(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def hat(omega: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [..., 3, 3] of omega [..., 3]."""
    ox, oy, oz = jnp.moveaxis(omega, -1, 0)
    zero = jnp.zeros_like(ox)
    m = jnp.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], axis=-1)
    return m.reshape(omega.shape[:-1] + (3, 3))


def exp(twist: jnp.ndarray) -> SE3:
    """SE(3) exponential of twist [..., 6] = [omega, v] (rotation first).

    Taylor-guarded for small angles so the map is differentiable at 0.
    """
    omega, v = twist[..., :3], twist[..., 3:]
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    small = theta2 < 1e-12
    # Guard the sqrt argument itself: sqrt has an infinite derivative at 0 and
    # jnp.where does not stop NaNs propagating through the unselected branch.
    safe_theta2 = jnp.where(small, 1.0, theta2)
    safe_theta = jnp.sqrt(safe_theta2)
    theta = jnp.where(small, 0.0, safe_theta)

    # Quaternion from axis-angle.
    half = 0.5 * safe_theta
    sinc_half = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / safe_theta)
    qw = jnp.cos(0.5 * theta)
    q = jnp.concatenate([qw, omega * sinc_half], axis=-1)

    # V matrix: t = V @ v with
    # V = I + (1-cos th)/th^2 [w]x + (th - sin th)/th^3 [w]x^2
    A = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_theta)) / safe_theta2)
    B = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe_theta - jnp.sin(safe_theta)) / (safe_theta2 * safe_theta))
    wx = hat(omega)
    wx2 = wx @ wx
    Vm = (jnp.eye(3, dtype=twist.dtype) + A[..., None] * wx + B[..., None] * wx2)
    t = jnp.einsum("...ij,...j->...i", Vm, v)
    return SE3(quat_normalize(q), t)


def log(T: SE3) -> jnp.ndarray:
    """SE(3) logarithm -> twist [..., 6] = [omega, v]."""
    q = quat_normalize(T.q)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    u = q[..., 1:]
    un2 = jnp.sum(u * u, axis=-1, keepdims=True)
    small = un2 < 1e-14
    un = jnp.sqrt(jnp.where(small, 1.0, un2))
    theta_full = 2.0 * jnp.arctan2(jnp.where(small, 0.0, un), w)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), theta_full / un)
    omega = u * scale

    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    small_t = theta2 < 1e-12
    safe_th2 = jnp.where(small_t, 1.0, theta2)
    safe_th = jnp.sqrt(safe_th2)
    half = 0.5 * safe_th
    # V^{-1} = I - 1/2 [w]x + (1/th^2)(1 - A/(2B)) [w]x^2 with standard A,B
    cot_term = jnp.where(
        small_t,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / safe_th2,
    )
    wx = hat(omega)
    Vinv = jnp.eye(3, dtype=omega.dtype) - 0.5 * wx + cot_term[..., None] * (wx @ wx)
    v = jnp.einsum("...ij,...j->...i", Vinv, T.t)
    return jnp.concatenate([omega, v], axis=-1)


def retract(T: SE3, twist: jnp.ndarray) -> SE3:
    """Left-multiplicative update ``exp(twist) * T`` (g2o VertexSE3Expmap oplus)."""
    return compose(exp(twist), T)


def slerp(T0: SE3, T1: SE3, u) -> SE3:
    """Independent slerp of rotation + lerp of translation.

    Matches the reference's trajectory interpolation during initialization
    refinement (/root/reference/modules/tracking/monocular_map_initializer.cc:263-270),
    which slerps the quaternion and linearly scales the translation.
    """
    u_arr = jnp.asarray(u)
    t = T0.t + (T1.t - T0.t) * u_arr[..., None]
    return SE3(quat_slerp(T0.q, T1.q, u_arr), t)


def stack(transforms, axis=0) -> SE3:
    return SE3(jnp.stack([T.q for T in transforms], axis=axis),
               jnp.stack([T.t for T in transforms], axis=axis))


def index(T: SE3, idx) -> SE3:
    return SE3(T.q[idx], T.t[idx])
