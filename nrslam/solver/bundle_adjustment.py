"""Local deformable bundle adjustment over a sliding keyframe window.

JAX-native equivalent of LocalDeformableBundleAdjustment
(/root/reference/modules/optimization/g2o_optimization.cc:880-1161):

Variables: the last <= 5 keyframe poses and a SEPARATE copy of every observed
landmark per keyframe (the map deforms, so each keyframe sees its own
geometry). Factors:
- reprojection per (keyframe, observed landmark): info 1/0.5^2, Huber 5.99
- position springs per (keyframe, neighbor pair observed in that keyframe):
  ``1.1 * (||xi - xj|| - d0)/d0``, info 1/0.1^2, NO robust kernel (:1060-1070)
- 4-ary temporal dampers per (consecutive keyframe pair, neighbor pair
  observed in both): ``w * ((xi' - xi) - (xj' - xj))``, info 1/(0.1*scale)^2,
  Huber 0.584 (:1110-1130)

5 LM iterations, no re-leveling (:1140-1143). No gauge fixing — like the
reference, the global SE(3) gauge is resolved by the LM damping (and in the
pipeline by the fact that older KF landmarks anchor the window).

The coupled system (poses x per-KF landmarks with cross-KF dampers) is solved
by block-Jacobi preconditioned CG with edge-list Hessian-vector products —
the keyframe axis is the natural sharding axis for the distributed version
(see nrslam/parallel).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3
from nrslam.solver import core, residuals
from nrslam.solver.pose_deformation import PairEdges

TH_2DOF = 5.99
TH_3DOF = 0.584
INFO_REPROJECTION = 1.0 / (0.5 ** 2)
INFO_POSITION = 1.0 / (0.1 ** 2)
SPRING_K = 1.1


class BAProblem(NamedTuple):
    obs: jnp.ndarray        # [K, P, 2] keypoints per keyframe
    obs_valid: jnp.ndarray  # [K, P] TRACKED_WITH_3D in that keyframe
    kf_valid: jnp.ndarray   # [K] keyframe slot in use
    pairs: PairEdges        # neighbor pair table (shared across KFs)
    scale: jnp.ndarray      # map scale (sets damper sigma)


def _masks(problem: BAProblem):
    """Static factor masks: reprojection [K,P], springs [K,E], dampers [K-1,E]."""
    obs_ok = problem.obs_valid & problem.kf_valid[:, None]
    pv = problem.pairs.valid
    spring = (obs_ok[:, problem.pairs.i] & obs_ok[:, problem.pairs.j]
              & pv[None])                                       # [K, E]
    damper = spring[:-1] & spring[1:]                           # [K-1, E]
    return obs_ok, spring, damper


def _system(cam, poses: se3.SE3, L: jnp.ndarray, problem: BAProblem,
            obs_mask, spring_mask, damper_mask, info_s, S):
    """chi2, gradient, hvp and diagonal for the BA normal equations.

    Parameter layout: [K*6 twists, K*P*3 landmarks]. Edge gathers/scatters
    are phrased through the dense one-hot selectors S = (Si, Sj) [E, P]
    (matmuls instead of scatter ops).
    """
    K, P, _ = L.shape
    pairs = problem.pairs
    Si, Sj = S
    Sd = Si - Sj

    # --- Reprojection ---
    e_r, J_pose, J_land = residuals.reprojection(
        cam, jax.tree.map(lambda x: x[:, None], poses), L, problem.obs)
    # Masked observations may be NaN (invalid keyframe slots); zero them so
    # the mask multiplication really removes them (NaN * 0 = NaN otherwise).
    e_r = jnp.where(obs_mask[..., None] > 0, e_r, 0.0)
    chi2_r = INFO_REPROJECTION * jnp.sum(e_r * e_r, axis=-1)
    w_r = INFO_REPROJECTION * core.huber_weight(chi2_r, TH_2DOF) * obs_mask

    # --- Springs (no Huber) ---
    diff = core.selmm_exact("ep,kpl->kel", Sd, L)               # [K, E, 3]
    dist = jnp.linalg.norm(diff, axis=-1)
    safe_d0 = jnp.maximum(pairs.d0, 1e-12)[None]
    e_p = SPRING_K * (dist - pairs.d0[None]) / safe_d0
    chi2_p = INFO_POSITION * e_p * e_p
    w_p = INFO_POSITION * spring_mask
    a = (SPRING_K / safe_d0)[..., None] * diff / jnp.maximum(dist, 1e-12)[..., None]

    # --- Temporal dampers ---
    dflow = (L[1:] - L[:-1])                                    # [K-1, P, 3]
    ddiff = core.selmm_exact("ep,kpl->kel", Sd, dflow)          # [K-1, E, 3]
    e_d = pairs.w[None, :, None] * ddiff
    chi2_d = info_s * jnp.sum(e_d * e_d, axis=-1)
    w_d = info_s * core.huber_weight(chi2_d, TH_3DOF) * damper_mask
    wd2 = w_d * pairs.w[None] ** 2                              # [K-1, E]

    chi2 = (jnp.sum(core.huber_rho(chi2_r, TH_2DOF) * obs_mask)
            + jnp.sum(chi2_p * spring_mask)
            + jnp.sum(core.huber_rho(chi2_d, TH_3DOF) * damper_mask))

    # --- Gradient ---
    g_pose = jnp.einsum("kpri,kp,kpr->ki", J_pose, w_r, e_r)    # [K, 6]
    g_land = jnp.einsum("kprl,kp,kpr->kpl", J_land, w_r, e_r)   # [K, P, 3]
    gp = (w_p * e_p)[..., None] * a
    g_land = g_land + core.selmm("ep,kel->kpl", Sd, gp)
    gd = wd2[..., None] * ddiff
    # d(e_d)/dL: cur keyframe gets -, next gets + (per endpoint sign).
    g_ddiff = core.selmm("ep,kel->kpl", Sd, gd)                 # [K-1, P, 3]
    g_land = (g_land.at[:-1].add(-g_ddiff)).at[1:].add(g_ddiff)
    g = jnp.concatenate([g_pose.reshape(-1), g_land.reshape(-1)])

    # --- Block diagonal (preconditioner) ---
    H_pose = jnp.einsum("kpri,kp,kprj->kij", J_pose, w_r, J_pose)
    D = jnp.einsum("kprl,kp,kprm->kplm", J_land, w_r, J_land)
    eye3 = jnp.eye(3, dtype=L.dtype)
    both = Si + Sj
    aaT = w_p[..., None, None] * a[..., :, None] * a[..., None, :]
    D = D + core.selmm("ep,kelm->kplm", both, aaT)
    wd2p = core.selmm("ep,ke->kp", both, wd2)                   # [K-1, P]
    D = D.at[:-1].add(wd2p[..., None, None] * eye3)
    D = D.at[1:].add(wd2p[..., None, None] * eye3)

    def hvp(v, lam):
        vp = v[:K * 6].reshape(K, 6)
        vl = v[K * 6:].reshape(K, P, 3)
        r_lin = (jnp.einsum("kpri,ki->kpr", J_pose, vp)
                 + jnp.einsum("kprl,kpl->kpr", J_land, vl))
        out_pose = jnp.einsum("kpri,kp,kpr->ki", J_pose, w_r, r_lin)
        out_land = jnp.einsum("kprl,kp,kpr->kpl", J_land, w_r, r_lin)
        # springs
        dv = core.selmm("ep,kpl->kel", Sd, vl)
        pv = (w_p * jnp.einsum("kel,kel->ke", a, dv))[..., None] * a
        out_land = out_land + core.selmm("ep,kel->kpl", Sd, pv)
        # dampers
        dvf = vl[1:] - vl[:-1]
        sv = wd2[..., None] * core.selmm("ep,kpl->kel", Sd, dvf)
        sv_land = core.selmm("ep,kel->kpl", Sd, sv)
        out_land = (out_land.at[:-1].add(-sv_land)).at[1:].add(sv_land)
        out = jnp.concatenate([out_pose.reshape(-1), out_land.reshape(-1)])
        return out + lam * v

    return chi2, g, hvp, (H_pose, D)


def _block_preconditioner(H_pose, D, lam):
    """Inverse of the (per-KF pose 6x6, per-(KF,landmark) 3x3) blocks + lam*I.

    Block-Jacobi converges in noticeably fewer CG iterations than the scalar
    diagonal on these reprojection-dominated systems (the 3x3 landmark blocks
    are strongly anisotropic along the viewing ray).
    """
    K, P = D.shape[0], D.shape[1]
    Hp_inv = jnp.linalg.inv(H_pose + lam * jnp.eye(6, dtype=H_pose.dtype))
    # Closed-form 3x3 inverse instead of batched LU (jnp.linalg.inv).
    D_inv = core.inv3x3(D + lam * jnp.eye(3, dtype=D.dtype))

    def apply(r):
        rp = r[:K * 6].reshape(K, 6)
        rl = r[K * 6:].reshape(K, P, 3)
        zp = jnp.einsum("kij,kj->ki", Hp_inv, rp)
        zl = jnp.einsum("kplm,kpm->kpl", D_inv, rl)
        return jnp.concatenate([zp.reshape(-1), zl.reshape(-1)])

    return apply


@jax.named_scope("keyframe_ba")
def local_deformable_ba(cam: cameras.Camera, poses0: se3.SE3, L0: jnp.ndarray,
                        problem: BAProblem, n_iters: int = 5,
                        cg_iters: int = 32):
    """Run the BA window optimization.

    Args:
      poses0: [K] keyframe Tcw seeds.
      L0: [K, P, 3] per-keyframe landmark position seeds.

    Returns (poses [K], landmarks [K, P, 3]).
    """
    K, P, _ = L0.shape
    sigma_s = 0.1 * problem.scale
    info_s = 1.0 / (sigma_s * sigma_s)
    from nrslam.solver.pose_deformation import scatter_matrices
    S = scatter_matrices(problem.pairs, P)
    obs_mask, spring_mask, damper_mask = _masks(problem)
    obs_mask = obs_mask.astype(jnp.float32)
    spring_mask = spring_mask.astype(jnp.float32)
    damper_mask = damper_mask.astype(jnp.float32)

    chi0, g, hvp, (H_pose0, D0) = _system(cam, poses0, L0, problem, obs_mask,
                                          spring_mask, damper_mask, info_s, S)
    diag0 = jnp.concatenate([
        jnp.diagonal(H_pose0, axis1=-2, axis2=-1).reshape(-1),
        jnp.diagonal(D0, axis1=-2, axis2=-1).reshape(-1)])
    lam0 = core.lm_lambda_init(diag0)

    def body(_, state):
        q, t, L, lam, nu, chi2_cur = state
        poses = se3.SE3(q, t)
        _, g, hvp, (H_pose, D) = _system(cam, poses, L, problem, obs_mask,
                                         spring_mask, damper_mask, info_s, S)
        m_inv = _block_preconditioner(H_pose, D, lam)
        dx = core.pcg(lambda v: hvp(v, lam), -g, m_inv, cg_iters)
        d_pose = dx[:K * 6].reshape(K, 6)
        d_land = dx[K * 6:].reshape(K, P, 3)
        poses_new = se3.retract(poses, d_pose)
        L_new = L + d_land
        chi2_new, _, _, _ = _system(cam, poses_new, L_new, problem, obs_mask,
                                    spring_mask, damper_mask, info_s, S)
        denom = jnp.dot(dx, lam * dx - g)
        rho = (chi2_cur - chi2_new) / jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        q = jnp.where(accepted, poses_new.q, q)
        t = jnp.where(accepted, poses_new.t, t)
        L = jnp.where(accepted, L_new, L)
        chi2_cur = jnp.where(accepted, chi2_new, chi2_cur)
        return q, t, L, lam, nu, chi2_cur

    q, t, L, *_ = jax.lax.fori_loop(
        0, n_iters, body,
        (poses0.q, poses0.t, L0, lam0, jnp.float32(2.0), chi0))
    return se3.SE3(q, t), L
