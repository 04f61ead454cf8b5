"""Joint camera-pose + deformation optimization (the tracking backbone).

JAX-native equivalent of CameraPoseAndDeformationOptimization
(/root/reference/modules/optimization/g2o_optimization.cc:148-557):

Variables: one SE(3) twist + a per-point 3D deformation ("flow") delta.
Factors per TRACKED_WITH_3D point i (fixed capacity, masked):
- reprojection of ``rest_i + flow_i`` (info 1/0.5^2, Huber d2=5.99)
- <= 10 spatial dampers ``w_ij (flow_i - flow_j)`` against graph neighbors
  (info 1/(0.1*scale)^2, Huber d2=0.584)
- paired position springs ``1.1 (||(rest_i+f_i)-(rest_j+f_j)|| - d0)/d0``
  (info 1/0.1^2, Huber d2=0.584)

Schedule (g2o_optimization.cc:338-394): 2 rounds x 10 LM iterations; at each
round start the pose resets to the seed and flows reset to zero; between
rounds edges re-level by their chi2 (reprojection > 5.99, spatial > 0.584;
springs always stay active).

The normal equations couple all points through the pair edges, so instead of
g2o's sparse Cholesky we run Jacobi-block-preconditioned CG with
Hessian-vector products assembled from the edge lists (einsums and
selector products — dense batched math).

Post-processing (:396-474) is done here too: IQR gating of deformation
magnitudes, demotion of reprojection outliers, and the phase-2 "drag"
solve for lost landmarks (:476-556) which reduces to independent per-point
robust means of neighbor flows (see ``lost_point_drag``).
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3
from nrslam.solver import core, residuals
from nrslam.utils import stats

TH_2DOF = 5.99
TH_3DOF = 0.584
SIGMA_REPROJECTION = 0.5
SIGMA_POSITION = 0.1
SPRING_K = 1.1


class PairEdges(NamedTuple):
    """Flattened undirected pair-edge table (spatial + position factors)."""

    i: jnp.ndarray      # [E] int32
    j: jnp.ndarray      # [E] int32
    w: jnp.ndarray      # [E] RBF weight (spatial damper gain)
    d0: jnp.ndarray     # [E] rest distance (spring measurement)
    valid: jnp.ndarray  # [E] bool


def pairs_from_neighbors(nbr_idx: jnp.ndarray, nbr_w: jnp.ndarray,
                         nbr_d0: jnp.ndarray, nbr_valid: jnp.ndarray) -> PairEdges:
    """Build deduplicated pair edges from a per-point top-K neighbor table.

    The reference deduplicates shared regularizers via hash sets
    (g2o_optimization.cc:296-300); here each unordered pair is kept exactly
    once: directed pair (i, j) survives iff ``i < j`` or the reverse direction
    is not itself a valid neighbor entry.
    """
    P, K = nbr_idx.shape
    src = jnp.repeat(jnp.arange(P, dtype=jnp.int32), K)
    dst = nbr_idx.reshape(-1)
    w = nbr_w.reshape(-1)
    d0 = nbr_d0.reshape(-1)
    valid = nbr_valid.reshape(-1)

    # mutual[e] = (src[e] appears in nbr list of dst[e])
    rev = nbr_idx[dst]                       # [E, K]
    rev_valid = nbr_valid[dst]               # [E, K]
    mutual = jnp.any((rev == src[:, None]) & rev_valid, axis=-1)
    keep = valid & ((src < dst) | ~mutual)
    return PairEdges(src, dst, w, d0, keep)


def edge_budget(P: int, E_raw: int) -> int:
    """Live-edge budget for a RAW directed P*K pair table: ceil(K/2)*P + P.

    K is recovered from the raw table shape (E_raw = P*K as produced by
    ``pairs_from_neighbors``) so raising ``config.regularizers_per_point``
    scales the budget instead of silently truncating valid regularization
    edges (the old hard-coded 6P assumed K=11). Do NOT re-apply to an
    already-compacted table — the inferred K would shrink and live edges
    would be dropped (compaction is applied exactly once, at
    ``pose_deformation_optimization`` / mapping entry)."""
    K = max(1, -(-E_raw // max(P, 1)))  # ceil, robust to padded tables
    return (-(-K // 2) + 1) * P


def compact_pairs(pairs: PairEdges, P: int,
                  point_valid: jnp.ndarray | None = None) -> PairEdges:
    """Compact the directed-table pair edges to the top-weight live subset.

    ``pairs_from_neighbors`` returns one row per DIRECTED neighbor entry
    (E = P*K) with ~half invalidated by the unordered-pair dedup — but every
    [E, P] selector matmul still streams the dead rows. The budget keeps the
    ``ceil(K/2)*P + P`` highest-RBF-weight valid edges — derived from the
    actual K of the table (the dedup keeps <= ~P*K/2 live edges; +P slack
    absorbs non-mutual pairs that survive both directions). Larger tables
    truncate lowest-weight first — RegularizationGraph::GetEdges' policy,
    regularization_graph.cc:61-87 — roughly halving the edge-matmul cost of
    the XLA joint driver and both BA variants. No-op when the table already
    fits the budget.
    """
    E_raw = pairs.i.shape[0]
    budget = ((min(E_raw, edge_budget(P, E_raw)) + 127) // 128) * 128
    if E_raw <= budget:
        return pairs
    base = pairs.valid
    if point_valid is not None:
        base = base & point_valid[pairs.i] & point_valid[pairs.j]
    score = jnp.where(base, pairs.w, -jnp.inf)
    _, esel = jax.lax.top_k(score, budget)
    return PairEdges(i=pairs.i[esel], j=pairs.j[esel], w=pairs.w[esel],
                     d0=pairs.d0[esel], valid=base[esel])


def scatter_matrices(pairs: PairEdges, P: int):
    """Dense one-hot endpoint-selection matrices Si/Sj [E, P] in bfloat16.

    Edge gathers are phrased as ``S @ x`` and scatter-adds as ``S^T @ y``,
    i.e. as matmuls. E = P*K is a few thousand, so the dense selectors are
    small. 0/1 entries are exact in
    bfloat16, which halves the selector HBM traffic — the dominant cost of
    every Hessian-vector product (see :func:`core.selmm`).
    """
    Si = jax.nn.one_hot(pairs.i, P, dtype=jnp.bfloat16)
    Sj = jax.nn.one_hot(pairs.j, P, dtype=jnp.bfloat16)
    return Si, Sj


class Linearization(NamedTuple):
    """System linearized at one (pose, flows) point — a pure-array pytree so
    it can ride a fori_loop carry (the Hv operator is rebuilt from it)."""

    g: jnp.ndarray        # [6+3P] gradient
    chi2: jnp.ndarray     # robustified total
    H_pose: jnp.ndarray   # [6, 6] pose diagonal block
    D_flow: jnp.ndarray   # [P, 3, 3] flow diagonal blocks
    J_pose: jnp.ndarray   # [P, 2, 6]
    J_flow: jnp.ndarray   # [P, 2, 3]
    w_r: jnp.ndarray      # [P] IRLS reprojection weights
    ws: jnp.ndarray       # [E] spatial gain^2 * IRLS weight
    w_p: jnp.ndarray      # [E] spring IRLS weight
    a: jnp.ndarray        # [E, 3] spring direction rows
    chi2_r: jnp.ndarray   # [P] per-point reprojection chi2
    chi2_s: jnp.ndarray   # [E] per-edge spatial chi2


def _system(cam, Tcw, rest, obs, flows, pairs, masks, infos, S):
    """Linearize at (Tcw, flows): gradient, chi2, Jacobian blocks, weights.

    Parameter vector layout: [twist(6), flows(3P)] flattened.
    """
    point_mask, spatial_mask, spring_mask = masks
    info_r, info_s, info_p = infos
    Si, Sj = S
    Sd = Si - Sj        # difference operator: Sd @ x = x_i - x_j

    # One reprojection linearization serves residuals AND Jacobian blocks.
    e_r, J_pose, J_flow = residuals.reprojection(cam, Tcw, rest + flows, obs)
    chi2_r = info_r * jnp.sum(e_r * e_r, axis=-1)

    # Edge differences as exact selector matmuls.
    dflow = core.selmm_exact("ep,pk->ek", Sd, flows)          # f_i - f_j
    e_s = pairs.w[:, None] * dflow
    chi2_s = info_s * jnp.sum(e_s * e_s, axis=-1)

    diff = core.selmm_exact("ep,pk->ek", Sd, rest) + dflow
    dist = jnp.linalg.norm(diff, axis=-1)
    safe_d0 = jnp.maximum(pairs.d0, 1e-12)
    e_p = SPRING_K * (dist - pairs.d0) / safe_d0
    chi2_p = info_p * e_p * e_p

    # IRLS weights (info * huber), masked.
    w_r = info_r * core.huber_weight(chi2_r, TH_2DOF) * point_mask
    w_s = info_s * core.huber_weight(chi2_s, TH_3DOF) * spatial_mask
    w_p = info_p * core.huber_weight(chi2_p, TH_3DOF) * spring_mask

    chi2_total = (jnp.sum(core.huber_rho(chi2_r, TH_2DOF) * point_mask)
                  + jnp.sum(core.huber_rho(chi2_s, TH_3DOF) * spatial_mask)
                  + jnp.sum(core.huber_rho(chi2_p, TH_3DOF) * spring_mask))

    ws = pairs.w * pairs.w * w_s                       # [E] spatial gain^2
    safe_dist = jnp.maximum(dist, 1e-12)
    a = (SPRING_K / jnp.maximum(pairs.d0, 1e-12))[:, None] * diff / safe_dist[:, None]

    # Gradient g = J^T W e (edge terms via S^T matmuls).
    g_pose = jnp.einsum("pri,p,pr->i", J_pose, w_r, e_r)
    g_flow = jnp.einsum("prk,p,pr->pk", J_flow, w_r, e_r)
    gs = (w_s * pairs.w)[:, None] * e_s + (w_p * e_p)[:, None] * a
    g_flow = g_flow + core.selmm("ep,ek->pk", Sd, gs)
    g = jnp.concatenate([g_pose, g_flow.reshape(-1)])

    # Block-diagonal of H for the preconditioner.
    H_pose = jnp.einsum("pri,p,prj->ij", J_pose, w_r, J_pose)  # [6,6]
    D_flow = jnp.einsum("prk,p,prl->pkl", J_flow, w_r, J_flow)  # [P,3,3]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    both = Si + Sj
    D_flow = D_flow + core.selmm("ep,e->p", both, ws)[:, None, None] * eye3
    aaT = w_p[:, None, None] * a[:, :, None] * a[:, None, :]
    D_flow = D_flow + core.selmm("ep,ekl->pkl", both, aaT)

    return Linearization(g, chi2_total, H_pose, D_flow, J_pose, J_flow,
                         w_r, ws, w_p, a, chi2_r, chi2_s)


def _make_hvp(lin: Linearization, S):
    """Gauss-Newton Hessian-vector operator from a carried linearization."""
    Si, Sj = S
    Sd = Si - Sj
    P = lin.J_flow.shape[0]

    def hvp(v, lam):
        vp = v[:6]
        vf = v[6:].reshape(P, 3)
        # Reprojection couples pose and flows.
        r_lin = (jnp.einsum("pri,i->pr", lin.J_pose, vp)
                 + jnp.einsum("prk,pk->pr", lin.J_flow, vf))
        out_pose = jnp.einsum("pri,p,pr->i", lin.J_pose, lin.w_r, r_lin)
        out_flow = jnp.einsum("prk,p,pr->pk", lin.J_flow, lin.w_r, r_lin)
        # Spatial dampers (w^2 I) and springs (rank-1 a a^T) act on vi - vj.
        dv = core.selmm("ep,pk->ek", Sd, vf)
        ev = (lin.ws[:, None] * dv
              + (lin.w_p * jnp.einsum("ek,ek->e", lin.a, dv))[:, None] * lin.a)
        out_flow = out_flow + core.selmm("ep,ek->pk", Sd, ev)
        out = jnp.concatenate([out_pose, out_flow.reshape(-1)])
        return out + lam * v

    return hvp


def _block_preconditioner(H_pose, D_flow, lam):
    """Inverse of the (pose 6x6, per-point 3x3) diagonal blocks + lam*I."""
    P = D_flow.shape[0]
    Hp = H_pose + lam * jnp.eye(6, dtype=H_pose.dtype)
    Df = D_flow + lam * jnp.eye(3, dtype=D_flow.dtype)[None]
    Df_inv = core.inv3x3(Df)      # closed form, no batched LU
    Hp_inv = jnp.linalg.inv(Hp)

    def apply(r):
        rp = r[:6]
        rf = r[6:].reshape(P, 3)
        zp = Hp_inv @ rp
        zf = jnp.einsum("pkl,pl->pk", Df_inv, rf)
        return jnp.concatenate([zp, zf.reshape(-1)])

    return apply


def _lm_optimize(cam, Tcw0, rest, obs, pairs, masks, infos, S, n_iters,
                 cg_iters):
    """LM with the linearization carried across iterations.

    Each iteration evaluates the system exactly once — at the trial point,
    where the evaluation doubles as the gain-ratio chi2 — instead of
    re-linearizing the accepted point a second time. The linearization is a
    pytree of arrays (g, chi2, Jacobian blocks, IRLS weights) selected by
    ``jnp.where`` on acceptance so it survives the fori_loop carry.
    """
    P = rest.shape[0]
    flows0 = jnp.zeros_like(rest)

    lin0 = _system(cam, Tcw0, rest, obs, flows0, pairs, masks, infos, S)
    diag0 = jnp.concatenate([jnp.diagonal(lin0.H_pose),
                             jax.vmap(jnp.diagonal)(lin0.D_flow).reshape(-1)])
    lam0 = core.lm_lambda_init(diag0)

    def cond(state):
        j, Tq, Tt, flows, lin, lam, nu, done = state
        return (j < n_iters) & ~done

    def body(state):
        j, Tq, Tt, flows, lin, lam, nu, done = state
        T = se3.SE3(Tq, Tt)
        hvp = _make_hvp(lin, S)
        m_inv = _block_preconditioner(lin.H_pose, lin.D_flow, lam)
        dx = core.pcg(lambda v: hvp(v, lam), -lin.g, m_inv, cg_iters)
        T_new = se3.retract(T, dx[:6])
        flows_new = flows + dx[6:].reshape(P, 3)
        lin_new = _system(cam, T_new, rest, obs, flows_new, pairs, masks,
                          infos, S)
        denom = jnp.dot(dx, lam * dx - lin.g)
        rho = (lin.chi2 - lin_new.chi2) / jnp.where(jnp.abs(denom) > 0,
                                                    denom, 1.0)
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        Tq = jnp.where(accepted, T_new.q, T.q)
        Tt = jnp.where(accepted, T_new.t, T.t)
        flows = jnp.where(accepted, flows_new, flows)
        lin = jax.tree.map(partial(jnp.where, accepted), lin_new, lin)
        # Machine-level accepted step => converged (early exit saves the
        # remaining serial LM+PCG iterations; see pose_only._lm_rounds).
        done = accepted & (jnp.dot(dx, dx) < 1e-12)
        return j + 1, Tq, Tt, flows, lin, lam, nu, done

    _, Tq, Tt, flows, *_ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), Tcw0.q, Tcw0.t, flows0, lin0, lam0, jnp.float32(2.0),
         jnp.array(False)))
    return se3.SE3(Tq, Tt), flows


class PoseDeformationResult(NamedTuple):
    Tcw: se3.SE3
    flows: jnp.ndarray            # [P, 3] optimized deformation deltas
    reproj_inlier: jnp.ndarray    # [P] bool (chi2 <= 5.99 at optimum)
    deform_ok: jnp.ndarray        # [P] bool (|flow| below IQR gate)
    median_deformation: jnp.ndarray  # scalar median |flow|


@jax.named_scope("pose_deformation_lm")
def pose_deformation_optimization(
        cam: cameras.Camera, Tcw0: se3.SE3, rest: jnp.ndarray,
        obs: jnp.ndarray, point_valid: jnp.ndarray, pairs: PairEdges,
        scale, rounds=(10, 10), cg_iters: int = 10) -> PoseDeformationResult:
    """Run the full two-round schedule and post-gating.

    Args:
      rest: [P, 3] world landmark rest positions (this frame's current map).
      obs: [P, 2] KLT observations.
      point_valid: [P] TRACKED_WITH_3D mask.
      pairs: deduplicated neighbor pair edges.
      scale: global map scale (spatial sigma is 0.1 * scale).
      cg_iters: inner PCG trips per LM step. 10 measures within ~1e-4 flow
        RMS of a 16-trip solve with identical inlier sets (the LM gain
        ratio re-validates every inexact step), at ~20% less frame time; 8
        under-resolves the weakly-observable depth axis of the flows.
    """
    # Edge compaction: drop dedup-dead selector rows.
    pairs = compact_pairs(pairs, rest.shape[0], point_valid)

    info_r = 1.0 / SIGMA_REPROJECTION ** 2
    info_p = 1.0 / SIGMA_POSITION ** 2
    sigma_s = 0.1 * scale
    info_s = 1.0 / (sigma_s * sigma_s)
    infos = (info_r, info_s, info_p)

    S = scatter_matrices(pairs, rest.shape[0])
    pair_base = (pairs.valid & point_valid[pairs.i] & point_valid[pairs.j])
    point_mask = point_valid.astype(jnp.float32)
    spatial_mask = pair_base.astype(jnp.float32)
    spring_mask = pair_base.astype(jnp.float32)

    T, flows = Tcw0, jnp.zeros_like(rest)
    for n in rounds:
        masks = (point_mask, spatial_mask, spring_mask)
        T, flows = _lm_optimize(cam, Tcw0, rest, obs, pairs, masks, infos,
                                S, n, cg_iters)
        # Re-level by chi2 at the optimum (springs stay active; the
        # reference's point-level spatial demotion is overwritten by the
        # per-edge check, g2o_optimization.cc:358-392).
        lin = _system(
            cam, T, rest, obs, flows, pairs,
            (point_valid.astype(jnp.float32),
             pair_base.astype(jnp.float32),
             pair_base.astype(jnp.float32)), infos, S)
        point_mask = (point_valid
                      & (lin.chi2_r <= TH_2DOF)).astype(jnp.float32)
        spatial_mask = (pair_base
                        & (lin.chi2_s <= TH_3DOF)).astype(jnp.float32)

    # Post-processing: reprojection gate + IQR deformation-magnitude gate
    # (g2o_optimization.cc:396-455).
    lin_final = _system(
        cam, T, rest, obs, flows, pairs,
        (point_valid.astype(jnp.float32),
         pair_base.astype(jnp.float32), pair_base.astype(jnp.float32)),
        infos, S)
    reproj_inlier = point_valid & (lin_final.chi2_r <= TH_2DOF)
    mag = jnp.linalg.norm(flows, axis=-1)
    deform_ok = point_valid & (mag < stats.iqr_upper_threshold(mag,
                                                               point_valid))
    median_def = stats.masked_median(mag, point_valid)
    return PoseDeformationResult(T, flows, reproj_inlier, deform_ok, median_def)


def lost_point_drag(flows: jnp.ndarray, lost_nbr_idx: jnp.ndarray,
                    lost_nbr_w: jnp.ndarray, lost_nbr_valid: jnp.ndarray,
                    scale, n_irls: int = 10) -> jnp.ndarray:
    """Phase-2 drag of lost landmarks along their neighbors' flow.

    The reference re-optimizes with the camera and accepted flows fixed and
    only SpatialRegularizerFixed unary edges on each lost vertex
    (g2o_optimization.cc:476-556); each lost flow therefore decouples into an
    independent robust weighted mean of its neighbors' flows
    ``argmin sum_j huber(|w_j (f - flow_j)|^2 / sigma_s^2)``, solved here by
    IRLS (vmapped over lost points).

    Args:
      flows: [P, 3] optimized flows of the tracked points.
      lost_nbr_idx/w/valid: [L, K] neighbor table for the lost points.

    Returns [L, 3] drag flows (add to last world positions).
    """
    sigma_s = 0.1 * scale
    info_s = 1.0 / (sigma_s * sigma_s)
    nbr_flows = flows[lost_nbr_idx]                       # [L, K, 3]
    w = lost_nbr_w * lost_nbr_valid.astype(jnp.float32)   # [L, K]

    def step(f, _):
        r = f[:, None, :] - nbr_flows                     # [L, K, 3]
        chi2 = info_s * jnp.sum((w[..., None] * r) ** 2, axis=-1)
        wt = w * w * core.huber_weight(chi2, TH_3DOF) * lost_nbr_valid
        denom = jnp.sum(wt, axis=-1, keepdims=True)
        f_new = jnp.sum(wt[..., None] * nbr_flows, axis=1) / jnp.maximum(denom, 1e-12)
        has_nbr = denom[:, 0] > 0
        return jnp.where(has_nbr[:, None], f_new, f), None

    f0 = jnp.zeros((lost_nbr_idx.shape[0], 3), flows.dtype)
    f, _ = jax.lax.scan(step, f0, None, length=n_irls)
    return f
