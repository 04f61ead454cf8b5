"""Pose-only camera optimization (motion-only BA).

JAX-native equivalent of CameraPoseOptimization
(/root/reference/modules/optimization/g2o_optimization.cc:50-146): one SE(3)
vertex, a unary reprojection edge per TRACKED_WITH_3D landmark, identity
information, Huber delta^2 = 5.99. Three rounds of 10 LM iterations; between
rounds the estimate resets to the initial seed and edges are re-leveled by
their chi2 at the round's optimum (chi2 > 5.99 -> excluded from the next
round, but re-tested every round so inliers can return).

Everything is fixed-capacity and masked: ``valid`` marks real observations;
the dense 6x6 normal equations are formed with one einsum each.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3
from nrslam.solver import core, residuals

TH_2DOF = 5.99


def _pose_system(cam, Tcw, X, obs, w_mask):
    """Weighted 6x6 normal equations for the unary reprojection edges."""
    e, J, _ = residuals.reprojection(cam, Tcw, X, obs)
    chi2 = jnp.sum(e * e, axis=-1)
    w_huber = core.huber_weight(chi2, TH_2DOF) * w_mask
    H = jnp.einsum("pri,p,prj->ij", J, w_huber, J)
    g = jnp.einsum("pri,p,pr->i", J, w_huber, e)
    total = jnp.sum(core.huber_rho(chi2, TH_2DOF) * w_mask)
    return H, g, total, chi2


def _lm_rounds(cam, Tcw0: se3.SE3, X, obs, w_mask, n_iters: int) -> se3.SE3:
    """n_iters of LM from Tcw0 over the masked edge set.

    The normal equations (H, g) of the CURRENT iterate are carried across
    iterations: each iteration evaluates the system exactly once (at the
    trial point, which doubles as the gain-ratio chi2 evaluation), instead
    of re-linearizing at the accepted point a second time.
    """
    H0, g0, chi0, _ = _pose_system(cam, Tcw0, X, obs, w_mask)
    lam0 = core.lm_lambda_init(jnp.diagonal(H0))

    def cond(state):
        j, T, H, g, lam, nu, chi2_cur, done = state
        return (j < n_iters) & ~done

    def body(state):
        j, T, H, g, lam, nu, chi2_cur, done = state
        dx = core.solve_dense(H, g, lam)
        T_new = se3.retract(T, dx)
        H_new, g_new, chi2_new, _ = _pose_system(cam, T_new, X, obs, w_mask)
        # g2o gain ratio: (chi2_old - chi2_new) / (dx . (lam*dx - g))
        denom = jnp.dot(dx, lam * dx - g)
        rho = (chi2_cur - chi2_new) / jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        T = jax.tree.map(lambda a, b: jnp.where(accepted, a, b), T_new, T)
        H = jnp.where(accepted, H_new, H)
        g = jnp.where(accepted, g_new, g)
        chi2_cur = jnp.where(accepted, chi2_new, chi2_cur)
        # Converged: an accepted step moved the estimate below machine level
        # (g2o's optimizer likewise terminates before maxiter on tiny gain).
        done = accepted & (jnp.dot(dx, dx) < 1e-12)
        return j + 1, T, H, g, lam, nu, chi2_cur, done

    _, T, *_ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), Tcw0, H0, g0, lam0, jnp.float32(2.0),
                     chi0, jnp.array(False)))
    return T


@jax.named_scope("pose_only_lm")
def camera_pose_optimization(cam: cameras.Camera, Tcw0: se3.SE3,
                             landmarks: jnp.ndarray, obs: jnp.ndarray,
                             valid: jnp.ndarray,
                             rounds=(10, 10, 10)) -> se3.SE3:
    """Optimize the camera pose against fixed world landmarks.

    Args:
      landmarks: [P, 3] world positions (fixed data, not variables).
      obs: [P, 2] pixel observations.
      valid: [P] bool — TRACKED_WITH_3D slots.

    Returns the optimized Tcw. Mirrors the reference's reset-per-round +
    chi2 re-leveling schedule (g2o_optimization.cc:106-141).
    """
    level0 = valid

    T = Tcw0
    for n in rounds:
        T = _lm_rounds(cam, Tcw0, landmarks, obs,
                       level0.astype(jnp.float32), n)
        _, _, _, chi2 = _pose_system(cam, T, landmarks, obs,
                                     valid.astype(jnp.float32))
        level0 = valid & (chi2 <= TH_2DOF)
    return T
