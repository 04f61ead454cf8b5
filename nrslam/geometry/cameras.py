"""Batched camera models: pinhole and Kannala-Brandt-8 fisheye.

Batched re-derivation of the reference camera models
(/root/reference/modules/calibration/pin_hole.cc:27-49 and
/root/reference/modules/calibration/kannala_brandt_8.cc:34-116): projection,
unprojection and the analytic 2x3 projection Jacobian, vectorized over
arbitrary leading batch dimensions.

A ``Camera`` is a pytree whose ``kind`` lives in static aux data, so jitted
functions specialize on the model at trace time (no dynamic dispatch on
device). Parameters:

- pinhole: ``[fx, fy, cx, cy]``
- kb8:     ``[fx, fy, cx, cy, k0, k1, k2, k3]`` (equidistant polynomial
  ``r(theta) = theta + k0 th^3 + k1 th^5 + k2 th^7 + k3 th^9``)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

PINHOLE = "pinhole"
KB8 = "kb8"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    params: jnp.ndarray
    kind: str = dataclasses.field(metadata=dict(static=True), default=PINHOLE)

    @property
    def fx(self):
        return self.params[..., 0]

    @property
    def fy(self):
        return self.params[..., 1]

    @property
    def cx(self):
        return self.params[..., 2]

    @property
    def cy(self):
        return self.params[..., 3]


def pinhole(fx, fy, cx, cy) -> Camera:
    return Camera(jnp.array([fx, fy, cx, cy], jnp.float32), PINHOLE)


def kannala_brandt8(fx, fy, cx, cy, k0, k1, k2, k3) -> Camera:
    return Camera(jnp.array([fx, fy, cx, cy, k0, k1, k2, k3], jnp.float32), KB8)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def project(cam: Camera, X: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame points X [..., 3] to pixels [..., 2]."""
    if cam.kind == PINHOLE:
        fx, fy, cx, cy = cam.params[:4]
        z = X[..., 2]
        return jnp.stack(
            [fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], axis=-1)
    elif cam.kind == KB8:
        fx, fy, cx, cy, k0, k1, k2, k3 = cam.params[:8]
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        r2 = x * x + y * y
        theta = jnp.arctan2(jnp.sqrt(r2), z)
        psi = jnp.arctan2(y, x)
        t2 = theta * theta
        r = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
        return jnp.stack([fx * r * jnp.cos(psi) + cx,
                          fy * r * jnp.sin(psi) + cy], axis=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def unproject(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Unproject pixels [..., 2] to rays [..., 3].

    Pinhole returns z=1 rays; KB8 returns unit-ish rays (sin/cos form) after a
    fixed 10-step Newton inversion of the distortion polynomial, mirroring
    /root/reference/modules/calibration/kannala_brandt_8.cc:53-85 but with a
    fixed iteration count (static control flow for XLA).
    """
    if cam.kind == PINHOLE:
        fx, fy, cx, cy = cam.params[:4]
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    elif cam.kind == KB8:
        fx, fy, cx, cy, k0, k1, k2, k3 = cam.params[:8]
        pwx = (uv[..., 0] - cx) / fx
        pwy = (uv[..., 1] - cy) / fy
        theta_d = jnp.sqrt(pwx * pwx + pwy * pwy)
        safe_td = jnp.maximum(theta_d, 1e-12)

        def newton_step(theta, _):
            t2 = theta * theta
            t4 = t2 * t2
            t6 = t4 * t2
            t8 = t4 * t4
            num = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8) - theta_d
            den = 1 + 3 * k0 * t2 + 5 * k1 * t4 + 7 * k2 * t6 + 9 * k3 * t8
            return theta - num / den, None

        theta, _ = jax.lax.scan(newton_step, theta_d, None, length=10)
        small = theta_d <= 1e-8
        theta = jnp.where(small, 0.0, theta)
        s = jnp.where(small, 1.0, jnp.sin(theta) / safe_td)
        return jnp.stack([s * pwx, s * pwy, jnp.cos(theta)], axis=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def projection_jacobian(cam: Camera, X: jnp.ndarray) -> jnp.ndarray:
    """Analytic d(project)/dX, shape [..., 2, 3]."""
    if cam.kind == PINHOLE:
        fx, fy, cx, cy = cam.params[:4]
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        zero = jnp.zeros_like(x)
        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        row0 = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
        row1 = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    elif cam.kind == KB8:
        # Re-derivation of kannala_brandt_8.cc:87-116.
        fx, fy, cx, cy, k0, k1, k2, k3 = cam.params[:8]
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        x2, y2, z2 = x * x, y * y, z * z
        r2 = x2 + y2
        r = jnp.sqrt(r2)
        r3 = r2 * r
        theta = jnp.arctan2(r, z)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        f = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8)
        fd = 1 + 3 * k0 * t2 + 5 * k1 * t4 + 7 * k2 * t6 + 9 * k3 * t8
        denom = r2 * (r2 + z2)
        j00 = fx * (fd * z * x2 / denom + f * y2 / r3)
        j01 = fx * (fd * z * x * y / denom - f * x * y / r3)
        j02 = -fx * fd * x / (r2 + z2)
        j10 = fy * (fd * z * x * y / denom - f * x * y / r3)
        j11 = fy * (fd * z * y2 / denom + f * x2 / r3)
        j12 = -fy * fd * y / (r2 + z2)
        row0 = jnp.stack([j00, j01, j02], axis=-1)
        row1 = jnp.stack([j10, j11, j12], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    raise ValueError(f"unknown camera kind {cam.kind}")


def unit_rays(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Unproject and L2-normalize (bearing rays for epipolar geometry)."""
    r = unproject(cam, uv)
    return r / jnp.linalg.norm(r, axis=-1, keepdims=True)
