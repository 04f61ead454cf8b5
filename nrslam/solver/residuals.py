"""Analytic residual + Jacobian blocks for the SLAM factor types.

Vectorized re-derivations of the g2o edge types in
/root/reference/modules/optimization/ (one file per edge there; one function
per edge here, batched over the edge axis):

- reprojection (pose, landmark):            reprojection_error.cc:32-64
- reprojection (pose only):                 reprojection_error_only_pose.cc:50-76
- reprojection w/ deformation delta:        reprojection_error_with_deformation.cc:37-64
- reprojection (landmark in camera frame):  reprojection_error_only_deformation.cc:32-38
- position ("spring") regularizer:          position_regularizer.cc:32-62
- spatial ("damper") regularizers:          spatial_regularizer*.cc

Conventions: residual is ``e`` with ``chi2 = e^T Omega e`` (Omega = info *
identity); pose Jacobians are wrt a left-multiplied twist ``[omega, v]``.
"""

from __future__ import annotations

import jax.numpy as jnp

from nrslam.geometry import cameras, se3


def expmap_point_jacobian(pc: jnp.ndarray) -> jnp.ndarray:
    """d(exp(delta) * pc)/d(delta) at delta=0: [..., 3, 6] = [-[pc]x | I]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        jnp.stack([zero, z, -y, one, zero, zero], -1),
        jnp.stack([-z, zero, x, zero, one, zero], -1),
        jnp.stack([y, -x, zero, zero, zero, one], -1),
    ]
    return jnp.stack(rows, axis=-2)


def reprojection(cam: cameras.Camera, Tcw: se3.SE3, X_world: jnp.ndarray,
                 obs: jnp.ndarray):
    """Reprojection residual e = obs - project(Tcw * X) with Jacobians.

    Returns (e [...,2], J_pose [...,2,6], J_point [...,2,3]).
    J_point is wrt the world point (or deformation delta added to it — same
    Jacobian, reprojection_error_with_deformation.cc:62).
    """
    pc = se3.apply(Tcw, X_world)
    e = obs - cameras.project(cam, pc)
    dpi = -cameras.projection_jacobian(cam, pc)
    J_pose = dpi @ expmap_point_jacobian(pc)
    R = se3.quat_to_matrix(Tcw.q)
    J_point = dpi @ R
    return e, J_pose, J_point


def reprojection_camera_frame(cam: cameras.Camera, X_cam: jnp.ndarray,
                              obs: jnp.ndarray):
    """Unary edge on a landmark expressed in camera coordinates.

    reprojection_error_only_deformation.cc:32-38 (numeric Jacobian there;
    analytic here — same linearization point).
    """
    e = obs - cameras.project(cam, X_cam)
    J = -cameras.projection_jacobian(cam, X_cam)
    return e, J


def position_spring(x1: jnp.ndarray, x2: jnp.ndarray, d0: jnp.ndarray,
                    k: float = 1.1):
    """Spring residual e = k * (||x1-x2|| - d0)/d0 with Jacobians [..., 1, 3].

    position_regularizer.cc:32-62. The reference's Jacobian uses
    ``2*(x1-x2) * k/(d0*sqrt(d))`` which is not the true derivative (the true
    one is ``(x1-x2)/(d*d0) * k``); we use the correct gradient — the residual
    (and thus the optimum) is identical, only the LM path differs.
    """
    diff = x1 - x2
    d = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    safe_d = jnp.maximum(d, 1e-12)
    e = k * (d[..., 0] - d0) / d0
    J1 = (k / d0)[..., None, None] * (diff / safe_d)[..., None, :]
    return e[..., None], J1, -J1


def spatial_flow_pair(flow1: jnp.ndarray, flow2: jnp.ndarray, w: jnp.ndarray):
    """Damper on two flow deltas: e = w * (flow1 - flow2).

    spatial_regularizer_with_deformation.cc:36-45. Jacobians are +-w*I.
    """
    e = w[..., None] * (flow1 - flow2)
    return e


def spatial_4ary(x1_cur, x2_cur, x1_next, x2_next, w):
    """4-ary damper e = w*((x1_next - x1_cur) - (x2_next - x2_cur)).

    spatial_regularizer.cc:32-63; Jacobians are -+wI / +-wI per vertex.
    """
    return w[..., None] * ((x1_next - x1_cur) - (x2_next - x2_cur))


def spatial_with_observation(xc_cur, xc_next, Twc_cur: se3.SE3,
                             Twc_next: se3.SE3, flow_obs, w):
    """Damper with measured neighbor scene-flow as observation.

    spatial_regularizer_with_observation.cc:32-50: vertices live in their
    camera frames, mapped to world by fixed poses; e = w*(obs - (world_next -
    world_cur)). The reference's Jacobians are approximated as +-w*I; we use
    the exact ones (+w*R_cur / -w*R_next rotations of the fixed poses).
    """
    world_cur = se3.apply(Twc_cur, xc_cur)
    world_next = se3.apply(Twc_next, xc_next)
    e = w[..., None] * (flow_obs - (world_next - world_cur))
    R_cur = se3.quat_to_matrix(Twc_cur.q)
    R_next = se3.quat_to_matrix(Twc_next.q)
    J_cur = w[..., None, None] * R_cur
    J_next = -w[..., None, None] * R_next
    return e, J_cur, J_next
