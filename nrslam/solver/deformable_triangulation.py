"""Deformable landmark triangulation, batched over candidates.

JAX-native equivalent of DeformableTriangulation
(/root/reference/modules/optimization/g2o_optimization.cc:559-814): for each
triangulation candidate, one 3D vertex per frame of its feature track, tied
together by measured neighbor scene-flow.

Per candidate:
- rigid pre-gates between the first and last track frames: midpoint
  triangulation, reprojection chi2 <= 5.991 at both views, parallax >=
  5 * radians-per-pixel (:603-634 — the reference hardcodes 0.0025 rad/px).
- per-frame seed: mean camera-frame depth of the image-space neighbors
  observed in that frame, along the unprojected ray (:636-663).
- factors: unary reprojection per frame (info 1/0.5^2, no robust kernel) +
  a damper per (frame-pair x neighbor) whose measurement is the neighbor's
  world scene-flow between the two frames (info 1/0.1^2, weight 1) (:665-761).
- 10 LM iterations, then acceptance: <= 50% of dampers with chi2 > 7.815 and
  <= 50% of frames with reprojection chi2 > 59.9 (:771-807).
- result: the last-frame vertex's z-depth pushed through the last ray
  (:809-813).

Design note: the per-frame vertices are parameterized in WORLD
coordinates (the reference uses per-frame camera coordinates,
g2o_optimization.cc:644-650). The change of variables per vertex is the
rigid map X_cam = R_cw X_world + t_cw; because the blocks are orthogonal,
the LM damping ball ||dx||^2 is preserved exactly, so the LM iterates are
mathematically identical. The payoff is structure: the damper Jacobians
become +-identity, so the Gauss-Newton Hessian is

    H = blockdiag(B_t) + Laplacian(W) (x) I_3

with 3x3 reprojection blocks B_t and a scalar [T, T] coupling Laplacian from
the dampers. Instead of materializing a dense [3T, 3T] Hessian and running a
batched Cholesky (60 serial factorization steps per LM iteration), the
solve is a batched block-Jacobi-preconditioned
CG whose Hessian-vector product is two small einsums.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3, triangulation
from nrslam.solver import core

INFO_REPROJECTION = 1.0 / (0.5 ** 2)
SIGMA_SPATIAL = 0.1
INFO_SPATIAL = 1.0 / (SIGMA_SPATIAL ** 2)
TH_3DOF = 7.815
REPROJ_REJECT = 5.99 * 10.0


class TriangulationInputs(NamedTuple):
    """Batched candidate data assembled from the temporal buffer."""

    obs: jnp.ndarray        # [C, T, 2] keypoint track per buffer frame
    track_valid: jnp.ndarray  # [C, T] frame is part of the track
    nbr_pos: jnp.ndarray    # [C, NB, T, 3] neighbor world positions per frame
    nbr_valid: jnp.ndarray  # [C, NB, T]
    cand_valid: jnp.ndarray  # [C] candidate has usable neighbors


def _first_last_idx(track_valid):
    """Indices of the first and last valid frames of each track."""
    T = track_valid.shape[-1]
    idx = jnp.arange(T)
    first = jnp.min(jnp.where(track_valid, idx, T), axis=-1)
    last = jnp.max(jnp.where(track_valid, idx, -1), axis=-1)
    first = jnp.clip(first, 0, T - 1)
    last = jnp.clip(last, 0, T - 1)
    return first, last


def rigid_pregate(cam: cameras.Camera, inputs: TriangulationInputs,
                  Tcw: se3.SE3, rad_per_pixel: float):
    """First/last-frame rigid triangulation gates (:603-634).

    Tcw: [T] camera-from-world poses for the buffer frames.
    Returns [C] bool.
    """
    first, last = _first_last_idx(inputs.track_valid)
    obs_f = jnp.take_along_axis(inputs.obs, first[:, None, None], axis=1)[:, 0]
    obs_l = jnp.take_along_axis(inputs.obs, last[:, None, None], axis=1)[:, 0]
    T_f = se3.index(Tcw, first)
    T_l = se3.index(Tcw, last)

    ray_f = cameras.unit_rays(cam, obs_f)
    ray_l = cameras.unit_rays(cam, obs_l)
    # Reference: TriangulateMidPoint(previous=back/last ray, current=front ray,
    # previous_pose=last, current_pose=first) — ray order (last, first).
    X = triangulation.triangulate_midpoint(ray_l, ray_f, T_l, T_f)

    Xf = se3.apply(T_f, X)
    Xl = se3.apply(T_l, X)
    e_f = triangulation.squared_reprojection_error(obs_f, cameras.project(cam, Xf))
    e_l = triangulation.squared_reprojection_error(obs_l, cameras.project(cam, Xl))

    n1 = X - se3.inverse(T_f).t
    n2 = X - se3.inverse(T_l).t
    parallax = triangulation.rays_parallax(n1, n2)

    ok = (jnp.isfinite(X).all(axis=-1)
          & (e_f <= 5.991) & (e_l <= 5.991)
          & (parallax >= rad_per_pixel * 5.0))
    return ok


def _seeds(cam, inputs: TriangulationInputs, Tcw: se3.SE3):
    """Per-frame camera-frame seeds from mean neighbor depth (:636-663)."""
    # neighbor camera-frame depth per (c, nb, t)
    nbr_cam = se3.apply(jax.tree.map(lambda x: x[None, None], Tcw), inputs.nbr_pos)
    depths = nbr_cam[..., 2]
    w = inputs.nbr_valid.astype(jnp.float32)
    n_nbr = jnp.sum(w, axis=1)                              # [C, T]
    depth_seed = jnp.sum(depths * w, axis=1) / jnp.maximum(n_nbr, 1.0)
    seed_ok = (n_nbr > 0) & (depth_seed > 0)
    rays = cameras.unproject(cam, inputs.obs)               # [C, T, 3]
    X0 = rays * depth_seed[..., None]
    return X0, seed_ok


def _assemble(cam, V, inputs: TriangulationInputs, frame_mask, pair_mask,
              flow_obs, Rcw, tcw):
    """chi2 + gradient + structured Hessian for one LM linearization.

    V: [C, T, 3] WORLD-frame vertices. flow_obs: [C, T, T, NB, 3] neighbor
    scene-flow measurements (t1 -> t2). Rcw/tcw: camera-from-world rotations
    [T, 3, 3] / translations [T, 3]. Returns (chi2 [C], g [C, T, 3],
    B [C, T, 3, 3] reprojection blocks, diag_L [C, T] Laplacian diagonal,
    Wsym [C, T, T] symmetric damper coupling, chi2_r [C, T],
    chi2_s [C, T, T, NB]).
    """
    # Reprojection (no robust kernel). ∂e_r/∂V = -Jproj @ R_cw.
    Xc = jnp.einsum("tij,ctj->cti", Rcw, V) + tcw[None]
    e_r = inputs.obs - cameras.project(cam, Xc)             # [C, T, 2]
    Jp = cameras.projection_jacobian(cam, Xc)               # [C, T, 2, 3]
    Jr = -jnp.einsum("ctri,tij->ctrj", Jp, Rcw)
    chi2_r = INFO_REPROJECTION * jnp.sum(e_r * e_r, axis=-1)
    w_r = INFO_REPROJECTION * frame_mask

    # Dampers act directly on world positions: e = obs_flow - (V_t2 - V_t1).
    dflow = V[:, None, :, :] - V[:, :, None, :]             # [C, T1, T2, 3]
    e_s = flow_obs - dflow[:, :, :, None, :]                # [C, T, T, NB, 3]
    chi2_s = INFO_SPATIAL * jnp.sum(e_s * e_s, axis=-1)
    w_s = INFO_SPATIAL * core.huber_weight(chi2_s, TH_3DOF) * pair_mask

    chi2 = (jnp.sum(chi2_r * frame_mask, axis=(-1,))
            + jnp.sum(core.huber_rho(chi2_s, TH_3DOF) * pair_mask, axis=(-1, -2, -3)))

    # Gradient: J^T w e. Damper Jacobians are +I at t1, -I at t2.
    g = jnp.einsum("ctri,ct,ctr->cti", Jr, w_r, e_r)
    s = jnp.sum(w_s[..., None] * e_s, axis=3)               # [C, T1, T2, 3]
    g = g + jnp.sum(s, axis=2) - jnp.sum(s, axis=1)

    # Structured Hessian: 3x3 reprojection blocks + scalar damper Laplacian.
    B = jnp.einsum("ctri,ct,ctrj->ctij", Jr, w_r, Jr)       # [C, T, 3, 3]
    w_sum = jnp.sum(w_s, axis=3)                            # [C, T1, T2]
    Wsym = w_sum + jnp.swapaxes(w_sum, 1, 2)                # diagonal is 0
    diag_L = jnp.sum(Wsym, axis=2)                          # [C, T]

    return chi2, g, B, diag_L, Wsym, chi2_r, chi2_s


def _batched_pcg(B, diag_L, Wsym, lam, b, n_iters: int):
    """Solve (H + lam I) x = b per candidate with block-Jacobi PCG.

    H v = B_t v_t + diag_L_t v_t - sum_u Wsym[t, u] v_u — two einsums per
    Hessian-vector product. b: [C, T, 3]; lam: [C].
    """
    eye3 = jnp.eye(3, dtype=b.dtype)
    d = (diag_L + lam[:, None])[..., None, None] * eye3
    Minv = core.inv3x3(B + d)

    def dotc(x, y):
        return jnp.sum(x * y, axis=(1, 2))

    def hv(v):
        return (jnp.einsum("ctij,ctj->cti", B, v)
                + (diag_L + lam[:, None])[..., None] * v
                - jnp.einsum("ctu,cuk->ctk", Wsym, v))

    x = jnp.zeros_like(b)
    r = b
    z = jnp.einsum("ctij,ctj->cti", Minv, r)
    p = z
    rz = dotc(r, z)

    def body(_, state):
        x, r, p, rz = state
        hp = hv(p)
        php = dotc(p, hp)
        alpha = jnp.where(php > 0, rz / jnp.maximum(php, 1e-30), 0.0)
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * hp
        z = jnp.einsum("ctij,ctj->cti", Minv, r)
        rz_new = dotc(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta[:, None, None] * p
        return x, r, p, rz_new

    x, *_ = jax.lax.fori_loop(0, n_iters, body, (x, r, p, rz))
    return x


@jax.named_scope("deformable_triangulation")
def deformable_triangulate(cam: cameras.Camera, inputs: TriangulationInputs,
                           Tcw: se3.SE3, rad_per_pixel: float,
                           min_track: int = 5, n_iters: int = 10,
                           cg_iters: int = 12):
    """Run the full batched deformable triangulation.

    Args:
      Tcw: [T] buffer-frame camera poses.
      cg_iters: inner PCG trips per LM step. The per-candidate system is
        only [T, 3] variables with a block-Jacobi preconditioner; measured
        landmark error is identical to 5 digits from 8 trips (rigid and
        deforming fixtures alike), so 12 keeps margin at ~40% of the old
        30-trip cost. The solve runs on every non-keyframe frame, so this
        is steady-state frame time.
    Returns (landmarks_world [C, 3], ok [C]).
    """
    C, T, _ = inputs.obs.shape

    track_len = jnp.sum(inputs.track_valid, axis=-1)
    pre_ok = (inputs.cand_valid & (track_len >= min_track)
              & rigid_pregate(cam, inputs, Tcw, rad_per_pixel))

    X0, seed_ok = _seeds(cam, inputs, Tcw)
    # Reference rejects the whole candidate if any track frame lacks
    # neighbors or has a negative seed (:652-663).
    seeds_all_ok = jnp.all(seed_ok | ~inputs.track_valid, axis=-1)
    pre_ok = pre_ok & seeds_all_ok

    Twc = se3.inverse(Tcw)
    Rcw = se3.quat_to_matrix(Tcw.q)                          # [T, 3, 3]
    tcw = Tcw.t

    # World-frame seeds (invalid track frames get a fixed placeholder).
    V0 = se3.apply(jax.tree.map(lambda x: x[None], Twc), X0)
    V0 = jnp.where(inputs.track_valid[..., None], V0, 1.0)

    # Neighbor scene-flow observations flow(t1 -> t2) per neighbor.
    flow_obs = (inputs.nbr_pos[:, :, None, :, :]             # [C, NB, 1, T, 3]
                - inputs.nbr_pos[:, :, :, None, :])          # -> [C, NB, T1, T2, 3]
    flow_obs = jnp.moveaxis(flow_obs, 1, 3)                  # [C, T1, T2, NB, 3]

    tri = jnp.tril(jnp.ones((T, T), bool), -1).T             # upper: t1 < t2
    pair_mask = (inputs.track_valid[:, :, None] & inputs.track_valid[:, None, :])
    nbr_both = jnp.moveaxis(
        inputs.nbr_valid[:, :, None, :] & inputs.nbr_valid[:, :, :, None], 1, 3)
    first, _ = _first_last_idx(inputs.track_valid)
    nbr_at_first = jnp.take_along_axis(
        inputs.nbr_valid, first[:, None, None], axis=2)[:, :, 0]  # [C, NB]
    pair_mask = (pair_mask[:, :, :, None] & nbr_both
                 & nbr_at_first[:, None, None, :]
                 & tri[None, :, :, None]).astype(jnp.float32)
    frame_mask = inputs.track_valid.astype(jnp.float32)

    chi0, g0, B0, dL0, W0, _, _ = _assemble(cam, V0, inputs, frame_mask,
                                            pair_mask, flow_obs, Rcw, tcw)
    diag = jnp.max(jax.vmap(jnp.diagonal)(B0.reshape(C * T, 3, 3))
                   .reshape(C, T, 3), axis=(-1,))
    lam0 = core.LM_TAU * jnp.max(diag + dL0, axis=-1)        # per candidate

    def body(_, state):
        # The linearization of the CURRENT iterate rides the carry: each
        # iteration assembles the system exactly once — at the trial point,
        # where it doubles as the gain-ratio chi2 — instead of re-linearizing
        # the accepted point a second time.
        V, lam, nu, chi2_cur, g, B, dL, W = state
        dx = _batched_pcg(B, dL, W, lam, -g, cg_iters)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        V_new = V + dx
        chi2_new, g_new, B_new, dL_new, W_new, _, _ = _assemble(
            cam, V_new, inputs, frame_mask, pair_mask, flow_obs, Rcw, tcw)
        denom = jnp.sum(dx * (lam[:, None, None] * dx - g), axis=(1, 2))
        rho = (chi2_cur - chi2_new) / jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        acc = accepted[:, None, None]
        V = jnp.where(acc, V_new, V)
        chi2_cur = jnp.where(accepted, chi2_new, chi2_cur)
        g = jnp.where(acc, g_new, g)
        B = jnp.where(acc[..., None], B_new, B)
        dL = jnp.where(accepted[:, None], dL_new, dL)
        W = jnp.where(acc, W_new, W)
        return V, lam, nu, chi2_cur, g, B, dL, W

    V, *_ = jax.lax.fori_loop(
        0, n_iters, body,
        (V0, lam0, jnp.full((C,), 2.0, V0.dtype), chi0, g0, B0, dL0, W0))

    # Acceptance gates (:771-807).
    _, _, _, _, _, chi2_r, chi2_s = _assemble(cam, V, inputs, frame_mask,
                                              pair_mask, flow_obs, Rcw, tcw)
    n_pairs = jnp.sum(pair_mask, axis=(-1, -2, -3))
    bad_pairs = jnp.sum((chi2_s > TH_3DOF) * pair_mask, axis=(-1, -2, -3))
    pairs_ok = bad_pairs <= 0.5 * jnp.maximum(n_pairs, 1.0)

    n_frames = jnp.sum(frame_mask, axis=-1)
    bad_frames = jnp.sum((chi2_r > REPROJ_REJECT) * frame_mask, axis=-1)
    frames_ok = bad_frames <= 0.5 * jnp.maximum(n_frames, 1.0)

    # Result from the last frame's depth along its ray (:809-813).
    _, last = _first_last_idx(inputs.track_valid)
    V_last = jnp.take_along_axis(V, last[:, None, None], axis=1)[:, 0]
    T_last_cw = se3.index(Tcw, last)
    X_last = se3.apply(T_last_cw, V_last)                    # camera frame
    obs_last = jnp.take_along_axis(inputs.obs, last[:, None, None], axis=1)[:, 0]
    ray = cameras.unproject(cam, obs_last)
    ray = ray / ray[..., 2:3]
    depth = X_last[..., 2]
    T_last = se3.index(Twc, last)
    landmark_world = se3.apply(T_last, ray * depth[..., None])

    ok = (pre_ok & pairs_ok & frames_ok & (n_pairs > 0)
          & jnp.isfinite(landmark_world).all(axis=-1))
    return landmark_world, ok
