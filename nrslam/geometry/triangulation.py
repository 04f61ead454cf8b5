"""Two-view triangulation and parallax utilities (batched).

Re-derivation of the inverse-depth-weighted midpoint method (Lee & Civera,
"Triangulation: Why Optimize?", arXiv:1907.11917) used by the reference at
/root/reference/modules/utilities/geometry_toolbox.cc:45-78, vectorized over
leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

from nrslam.geometry import se3


def rays_parallax_cosine(ray1: jnp.ndarray, ray2: jnp.ndarray) -> jnp.ndarray:
    num = jnp.sum(ray1 * ray2, axis=-1)
    den = jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(ray2, axis=-1)
    return num / den


def rays_parallax(ray1: jnp.ndarray, ray2: jnp.ndarray) -> jnp.ndarray:
    """Angle (radians) between two bundles of rays [..., 3]."""
    return jnp.arccos(jnp.minimum(rays_parallax_cosine(ray1, ray2), 1.0))


def triangulate_midpoint(ray1: jnp.ndarray, ray2: jnp.ndarray,
                         T1w: se3.SE3, T2w: se3.SE3) -> jnp.ndarray:
    """Inverse-depth-weighted midpoint triangulation.

    Args:
      ray1: bearing rays in camera-1 frame [..., 3] (need not be unit).
      ray2: bearing rays in camera-2 frame [..., 3].
      T1w, T2w: camera-from-world transforms (Tcw convention), batched or not.

    Returns world-frame points [..., 3]. Degenerate configurations yield
    non-finite values the caller must mask (the reference returns StatusOr and
    callers gate on parallax/reprojection anyway).
    """
    f0 = ray1 / jnp.linalg.norm(ray1, axis=-1, keepdims=True)
    f1 = ray2 / jnp.linalg.norm(ray2, axis=-1, keepdims=True)

    T10 = se3.compose(T2w, se3.inverse(T1w))
    t = T10.t
    Rf0 = se3.quat_rotate(T10.q, f0)

    p = jnp.cross(Rf0, f1)
    q = jnp.cross(Rf0, jnp.broadcast_to(t, Rf0.shape))
    r = jnp.cross(f1, jnp.broadcast_to(t, f1.shape))

    qn = jnp.linalg.norm(q, axis=-1, keepdims=True)
    rn = jnp.linalg.norm(r, axis=-1, keepdims=True)
    pn = jnp.linalg.norm(p, axis=-1, keepdims=True)

    x1 = qn / (qn + rn) * (t + rn / pn * (Rf0 + f1))
    return se3.apply(se3.inverse(T2w), x1)


def squared_reprojection_error(uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    d = uv1 - uv2
    return jnp.sum(d * d, axis=-1)
