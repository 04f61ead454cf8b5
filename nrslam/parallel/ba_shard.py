"""Keyframe-axis sharded local deformable bundle adjustment.

The BA window factor graph (solver/bundle_adjustment.py, the JAX-native
equivalent of /root/reference/modules/optimization/g2o_optimization.cc:880-
1161) has a natural block structure along the keyframe axis: reprojection and
position-spring factors touch a single keyframe's variables, while the 4-ary
temporal dampers (reference: modules/optimization/spatial_regularizer.cc:32-63)
couple CONSECUTIVE keyframes only. That makes the keyframe axis the SLAM
analogue of context/sequence parallelism (SURVEY.md §5): each device owns a
contiguous block of keyframes plus its per-KF landmark copies, and the only
cross-device coupling is a 1-keyframe halo at each block boundary.

SPMD layout over a ``Mesh((n,), ("kf",))``:
- poses [K], landmarks [K, P, 3], observations [K, P, 2] shard over ``kf``
  (block size Kl = K // n); the pair-edge table and map scale replicate.
- Boundary dampers between a block's last keyframe and the next block's
  first keyframe are evaluated on the OWNING (left) block using a halo of
  the neighbor's first-KF landmarks fetched with ``lax.ppermute`` over ICI;
  their gradient / Hessian-vector contributions to the neighbor's variables
  are returned by the reverse ppermute. Scalar reductions (chi2, CG dots,
  LM gain) are psums, so every device steps the identical LM trajectory.

The math is factor-for-factor the one in bundle_adjustment._system; the
parity test (tests/test_parallel.py) checks the sharded solve against the
single-device solver on the same window.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from nrslam.geometry import cameras, se3
from nrslam.solver import core, residuals
from nrslam.solver.bundle_adjustment import (
    BAProblem, INFO_POSITION, INFO_REPROJECTION, SPRING_K, TH_2DOF, TH_3DOF,
    _block_preconditioner)
from nrslam.solver.pose_deformation import scatter_matrices


def _perm_recv_next(n):
    """ppermute pairs so block b receives block b+1's payload."""
    return [(i, i - 1) for i in range(1, n)]


def _perm_send_next(n):
    """ppermute pairs so block b's payload lands on block b+1."""
    return [(i, i + 1) for i in range(n - 1)]


def _system_block(cam, poses, L, obs, obs_mask, spring_mask, damper_int,
                  damper_bnd, pairs, info_s, S, n):
    """Per-block chi2 / gradient / hvp / diagonal with boundary halo terms.

    All arrays are the local keyframe block ([Kl, ...]); ``damper_bnd`` [E]
    masks the boundary dampers owned by this block (zero on the last block).
    """
    Kl, Pn, _ = L.shape
    Si, Sj = S
    Sd = Si - Sj

    # --- Reprojection (block-local) ---
    e_r, J_pose, J_land = residuals.reprojection(
        cam, jax.tree.map(lambda x: x[:, None], poses), L, obs)
    e_r = jnp.where(obs_mask[..., None] > 0, e_r, 0.0)  # NaN-safe masking
    chi2_r = INFO_REPROJECTION * jnp.sum(e_r * e_r, axis=-1)
    w_r = INFO_REPROJECTION * core.huber_weight(chi2_r, TH_2DOF) * obs_mask

    # --- Springs (block-local, no Huber) ---
    diff = core.selmm_exact("ep,kpl->kel", Sd, L)
    dist = jnp.linalg.norm(diff, axis=-1)
    safe_d0 = jnp.maximum(pairs.d0, 1e-12)[None]
    e_p = SPRING_K * (dist - pairs.d0[None]) / safe_d0
    chi2_p = INFO_POSITION * e_p * e_p
    w_p = INFO_POSITION * spring_mask
    a = (SPRING_K / safe_d0)[..., None] * diff / jnp.maximum(
        dist, 1e-12)[..., None]

    # --- Temporal dampers: internal [Kl-1] + boundary halo ---
    L_next0 = jax.lax.ppermute(L[0], "kf", _perm_recv_next(n))  # halo [P, 3]
    dflow_i = L[1:] - L[:-1]
    ddiff_i = core.selmm_exact("ep,kpl->kel", Sd, dflow_i)
    chi2_di = info_s * jnp.sum(
        (pairs.w[None, :, None] * ddiff_i) ** 2, axis=-1)
    w_di = info_s * core.huber_weight(chi2_di, TH_3DOF) * damper_int
    wd2_i = w_di * pairs.w[None] ** 2                            # [Kl-1, E]

    dflow_b = L_next0 - L[-1]
    ddiff_b = core.selmm_exact("ep,pl->el", Sd, dflow_b)         # [E, 3]
    chi2_db = info_s * jnp.sum((pairs.w[:, None] * ddiff_b) ** 2, axis=-1)
    w_db = info_s * core.huber_weight(chi2_db, TH_3DOF) * damper_bnd
    wd2_b = w_db * pairs.w ** 2                                  # [E]

    chi2_local = (jnp.sum(core.huber_rho(chi2_r, TH_2DOF) * obs_mask)
                  + jnp.sum(chi2_p * spring_mask)
                  + jnp.sum(core.huber_rho(chi2_di, TH_3DOF) * damper_int)
                  + jnp.sum(core.huber_rho(chi2_db, TH_3DOF) * damper_bnd))
    chi2 = jax.lax.psum(chi2_local, "kf")

    # --- Gradient ---
    g_pose = jnp.einsum("kpri,kp,kpr->ki", J_pose, w_r, e_r)
    g_land = jnp.einsum("kprl,kp,kpr->kpl", J_land, w_r, e_r)
    gp = (w_p * e_p)[..., None] * a
    g_land = g_land + core.selmm("ep,kel->kpl", Sd, gp)
    gd_i = wd2_i[..., None] * ddiff_i
    g_ddiff = core.selmm("ep,kel->kpl", Sd, gd_i)
    g_land = (g_land.at[:-1].add(-g_ddiff)).at[1:].add(g_ddiff)
    # boundary damper: owning block's last KF gets -, neighbor's first KF +
    gd_b = wd2_b[:, None] * ddiff_b
    g_pt_b = core.selmm("ep,el->pl", Sd, gd_b)                   # [P, 3]
    g_land = g_land.at[-1].add(-g_pt_b)
    g_from_prev = jax.lax.ppermute(g_pt_b, "kf", _perm_send_next(n))
    g_land = g_land.at[0].add(g_from_prev)

    # --- Block-diagonal preconditioner ---
    H_pose = jnp.einsum("kpri,kp,kprj->kij", J_pose, w_r, J_pose)
    D = jnp.einsum("kprl,kp,kprm->kplm", J_land, w_r, J_land)
    eye3 = jnp.eye(3, dtype=L.dtype)
    both = Si + Sj
    aaT = w_p[..., None, None] * a[..., :, None] * a[..., None, :]
    D = D + core.selmm("ep,kelm->kplm", both, aaT)
    wd2p_i = core.selmm("ep,ke->kp", both, wd2_i)
    D = D.at[:-1].add(wd2p_i[..., None, None] * eye3)
    D = D.at[1:].add(wd2p_i[..., None, None] * eye3)
    wd2p_b = core.selmm("ep,e->p", both, wd2_b)                  # [P]
    D = D.at[-1].add(wd2p_b[..., None, None] * eye3)
    d_from_prev = jax.lax.ppermute(wd2p_b, "kf", _perm_send_next(n))
    D = D.at[0].add(d_from_prev[..., None, None] * eye3)

    def hvp(v, lam):
        vp = v[:Kl * 6].reshape(Kl, 6)
        vl = v[Kl * 6:].reshape(Kl, Pn, 3)
        r_lin = (jnp.einsum("kpri,ki->kpr", J_pose, vp)
                 + jnp.einsum("kprl,kpl->kpr", J_land, vl))
        out_pose = jnp.einsum("kpri,kp,kpr->ki", J_pose, w_r, r_lin)
        out_land = jnp.einsum("kprl,kp,kpr->kpl", J_land, w_r, r_lin)
        dv = core.selmm("ep,kpl->kel", Sd, vl)
        pv = (w_p * jnp.einsum("kel,kel->ke", a, dv))[..., None] * a
        out_land = out_land + core.selmm("ep,kel->kpl", Sd, pv)
        dvf = vl[1:] - vl[:-1]
        sv = wd2_i[..., None] * core.selmm("ep,kpl->kel", Sd, dvf)
        sv_land = core.selmm("ep,kel->kpl", Sd, sv)
        out_land = (out_land.at[:-1].add(-sv_land)).at[1:].add(sv_land)
        # boundary damper halo in the linearized operator
        vl_next0 = jax.lax.ppermute(vl[0], "kf", _perm_recv_next(n))
        dvf_b = vl_next0 - vl[-1]
        sv_b = wd2_b[:, None] * core.selmm("ep,pl->el", Sd, dvf_b)
        sv_pt = core.selmm("ep,el->pl", Sd, sv_b)
        out_land = out_land.at[-1].add(-sv_pt)
        sv_from_prev = jax.lax.ppermute(sv_pt, "kf", _perm_send_next(n))
        out_land = out_land.at[0].add(sv_from_prev)
        out = jnp.concatenate([out_pose.reshape(-1), out_land.reshape(-1)])
        return out + lam * v

    g = jnp.concatenate([g_pose.reshape(-1), g_land.reshape(-1)])
    return chi2, g, hvp, (H_pose, D)


def _pcg_dist(hvp, b, m_inv, iters, tol=1e-8):
    """PCG on a kf-distributed vector: local blocks, psum'd dot products.

    ``m_inv`` is a callable applying the (block-local) preconditioner."""
    def dot(u, v):
        return jax.lax.psum(jnp.vdot(u, v), "kf")

    x0 = jnp.zeros_like(b)
    z0 = m_inv(b)
    rz0 = dot(b, z0)
    b2 = dot(b, b)

    def body(_, state):
        x, r, p, rz, done = state
        hp = hvp(p)
        denom = dot(p, hp)
        alpha = jnp.where(jnp.abs(denom) > 0, rz / denom, 0.0)
        alpha = jnp.where(done, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * hp
        z = m_inv(r)
        rz_new = dot(r, z)
        beta = jnp.where(jnp.abs(rz) > 0, rz_new / rz, 0.0)
        p = z + beta * p
        done = done | (dot(r, r) <= tol * tol * b2)
        return x, r, p, jnp.where(done, rz, rz_new), done

    x, *_ = jax.lax.fori_loop(0, iters, body,
                              (x0, b, z0, rz0, jnp.array(False)))
    return x


def local_deformable_ba_kf_sharded(
        mesh: Mesh, cam: cameras.Camera, poses0: se3.SE3, L0: jnp.ndarray,
        problem: BAProblem, n_iters: int = 5, cg_iters: int = 32):
    """Keyframe-axis sharded BA solve; same contract as
    bundle_adjustment.local_deformable_ba.

    The keyframe count K must be divisible by the ``kf`` mesh axis size.
    """
    n = mesh.shape["kf"]
    K, Pn, _ = L0.shape
    assert K % n == 0, f"K={K} not divisible by kf axis size {n}"

    shard_map = jax.shard_map

    def solve(q, t, L, obs, obs_valid, kf_valid, pairs, scale):
        Kl = L.shape[0]
        sigma_s = 0.1 * scale
        info_s = 1.0 / (sigma_s * sigma_s)
        S = scatter_matrices(pairs, Pn)

        # static masks (per problem), with boundary halo
        obs_ok = (obs_valid & kf_valid[:, None]).astype(jnp.float32)
        pv = pairs.valid
        spring = (obs_ok[:, pairs.i] * obs_ok[:, pairs.j]
                  * pv[None].astype(jnp.float32))                 # [Kl, E]
        damper_int = spring[:-1] * spring[1:]
        spring_next0 = jax.lax.ppermute(spring[0], "kf", _perm_recv_next(n))
        idx = jax.lax.axis_index("kf")
        has_next = (idx < n - 1).astype(jnp.float32)
        damper_bnd = spring[-1] * spring_next0 * has_next          # [E]

        def system(q_, t_, L_):
            return _system_block(cam, se3.SE3(q_, t_), L_, obs, obs_ok,
                                 spring, damper_int, damper_bnd, pairs,
                                 info_s, S, n)

        chi0, g0, hvp0, (H_pose0, D0) = system(q, t, L)
        diag0 = jnp.concatenate([
            jnp.diagonal(H_pose0, axis1=-2, axis2=-1).reshape(-1),
            jnp.diagonal(D0, axis1=-2, axis2=-1).reshape(-1)])
        lam0 = core.LM_TAU * jax.lax.pmax(jnp.max(diag0), "kf")

        def body(_, state):
            q, t, L, lam, nu, chi2_cur = state
            _, g, hvp, (H_pose, D) = system(q, t, L)
            # Block-Jacobi preconditioner: purely block-local, so it shards
            # along kf with no extra communication.
            m_inv = _block_preconditioner(H_pose, D, lam)
            dx = _pcg_dist(lambda v: hvp(v, lam), -g, m_inv, cg_iters)
            d_pose = dx[:Kl * 6].reshape(Kl, 6)
            d_land = dx[Kl * 6:].reshape(Kl, Pn, 3)
            poses_new = se3.retract(se3.SE3(q, t), d_pose)
            L_new = L + d_land
            chi2_new, _, _, _ = system(poses_new.q, poses_new.t, L_new)
            denom = jax.lax.psum(jnp.dot(dx, lam * dx - g), "kf")
            rho = (chi2_cur - chi2_new) / jnp.where(
                jnp.abs(denom) > 0, denom, 1.0)
            lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
            q = jnp.where(accepted, poses_new.q, q)
            t = jnp.where(accepted, poses_new.t, t)
            L = jnp.where(accepted, L_new, L)
            chi2_cur = jnp.where(accepted, chi2_new, chi2_cur)
            return q, t, L, lam, nu, chi2_cur

        q, t, L, *_ = jax.lax.fori_loop(
            0, n_iters, body, (q, t, L, lam0, jnp.float32(2.0), chi0))
        return q, t, L

    sharded = shard_map(
        solve, mesh=mesh,
        in_specs=(P("kf"), P("kf"), P("kf"), P("kf"), P("kf"), P("kf"),
                  P(), P()),
        out_specs=(P("kf"), P("kf"), P("kf")),
        check_vma=False)
    q, t, L = jax.jit(sharded)(
        poses0.q, poses0.t, L0, problem.obs, problem.obs_valid,
        problem.kf_valid, problem.pairs, jnp.asarray(problem.scale))
    return se3.SE3(q, t), L
