"""Per-frame mapping: landmark triangulation and local deformable BA.

Functional re-design of the reference back end
(/root/reference/modules/mapping/mapping.cc), called synchronously after
tracking each frame (system.cc:113-132): after a keyframe -> bundle-adjust
the window and refresh the tracking frame; otherwise -> try to triangulate
the TRACKED-without-3D feature tracks, each by BOTH the rigid midpoint path
and the deformable path, then majority-vote which set to insert
(mapping.cc:192-209).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3, triangulation
from nrslam.ops import klt
from nrslam.slam import graph as graph_mod
from nrslam.slam import state as state_mod
from nrslam.slam.state import Config, SlamState
from nrslam.solver import bundle_adjustment as ba
from nrslam.solver import deformable_triangulation as dt
from nrslam.solver import pose_deformation as pd
from nrslam.utils.precision import highest_precision


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------

def _last_snapshot_index(state: SlamState):
    key = jnp.where(state.tb_valid, state.tb_frame_id, -1)
    return jnp.argmax(key)


def _closest_mapped_neighbors(state: SlamState, config: Config):
    """TemporalBuffer::GetClosestMapPointsToFeature for every slot at once
    (temporal_buffer.cc:97-143): the <= 11 nearest TRACKED_WITH_3D keypoints
    in the last snapshot within [min_px, max_px]; a neighbor closer than
    min_px disqualifies the candidate entirely.

    Returns (nbr_idx [P, NB], nbr_valid [P, NB], cand_ok [P]).
    """
    last = _last_snapshot_index(state)
    kps = state.tb_keypoints[last]
    with3d = state.tb_with3d[last]

    d = jnp.linalg.norm(kps[:, None] - kps[None], axis=-1)
    P = d.shape[0]
    eye = jnp.eye(P, dtype=bool)
    pairable = with3d[None, :] & ~eye
    too_close = jnp.any(pairable & (d < config.tri_min_neighbors_px), axis=1)
    ok_pair = pairable & (d <= config.tri_max_neighbors_px) \
        & (d >= config.tri_min_neighbors_px)
    score = jnp.where(ok_pair, -d, -jnp.inf)
    top_s, nbr_idx = jax.lax.top_k(score, config.tri_num_neighbors)
    nbr_valid = jnp.isfinite(top_s)
    cand_ok = ~too_close & jnp.any(nbr_valid, axis=1)
    return nbr_idx, nbr_valid, cand_ok


def _chronological(state: SlamState):
    """Temporal ring rolled to oldest->newest order + validity."""
    order = state_mod.chronological_temporal_order(state)
    return order, state.tb_valid[order]


def _rigid_triangulation(state: SlamState, cam, config: Config, order,
                         order_valid, candidates):
    """The rigid midpoint path with rigidity/parallax/reprojection gates
    (mapping.cc:117-189). Returns (landmarks [P, 3], ok [P])."""
    tb_tracked = state.tb_tracked[order]          # [T, P] chronological
    tb_kps = state.tb_keypoints[order]
    poses = se3.index(state.tb_pose, order)
    def_mag = state.tb_def_mag[order]
    T = order.shape[0]

    track = tb_tracked & order_valid[:, None]     # [T, P]
    idx = jnp.arange(T)[:, None]
    first = jnp.min(jnp.where(track, idx, T), axis=0)
    last = jnp.max(jnp.where(track, idx, -1), axis=0)
    has_track = last >= first
    first_c = jnp.clip(first, 0, T - 1)
    last_c = jnp.clip(last, 0, T - 1)

    # CheckRigidity over [first, last] (temporal_buffer.cc:218-227).
    in_window = (idx >= first_c[None, :]) & (idx <= last_c[None, :]) \
        & order_valid[:, None]
    rigid = ~jnp.any(in_window & (def_mag[:, None] > config.rigidity_threshold),
                     axis=0)

    P = track.shape[1]
    pr = jnp.arange(P)
    kp_first = tb_kps[first_c, pr]
    kp_last = tb_kps[last_c, pr]
    T_first = se3.index(poses, first_c)
    T_last = se3.index(poses, last_c)

    ray_first = cameras.unit_rays(cam, kp_first)
    ray_last = cameras.unit_rays(cam, kp_last)
    # Reference ray/pose order: (previous=last, current=first) (mapping.cc:128-141).
    X = triangulation.triangulate_midpoint(ray_last, ray_first, T_last, T_first)

    n1 = X - se3.inverse(T_first).t
    n2 = X - se3.inverse(T_last).t
    parallax = triangulation.rays_parallax(n1, n2)
    parallax_ok = ((parallax >= config.rad_per_pixel * 10.0)
                   & (parallax <= config.rad_per_pixel * 20.0))

    X1 = se3.apply(T_last, X)
    X2 = se3.apply(T_first, X)
    reproj_ok = (
        (X1[:, 2] > 0) & (X2[:, 2] > 0)
        & (triangulation.squared_reprojection_error(
            kp_last, cameras.project(cam, X1)) <= 5.991)
        & (triangulation.squared_reprojection_error(
            kp_first, cameras.project(cam, X2)) <= 5.991))

    ok = (candidates & has_track & rigid & parallax_ok & reproj_ok
          & jnp.isfinite(X).all(axis=-1))
    return X, ok


def _deformable_inputs(state: SlamState, config: Config, order, order_valid,
                       nbr_idx, nbr_valid, candidates):
    """Assemble TriangulationInputs from the temporal buffer (per slot)."""
    tb_tracked = state.tb_tracked[order]
    tb_kps = state.tb_keypoints[order]
    tb_pos = state.tb_positions[order]
    tb_3d = state.tb_with3d[order]

    track = (tb_tracked & order_valid[:, None]).T            # [P, T]
    obs = jnp.swapaxes(tb_kps, 0, 1)                          # [P, T, 2]
    # nbr_pos[c, nb, t] = position of neighbor nb at chronological frame t.
    nbr_pos = tb_pos[:, nbr_idx, :]                           # [T, P, NB, 3]
    nbr_pos = jnp.moveaxis(nbr_pos, 0, 2)                     # [P, NB, T, 3]
    nbr_ok = tb_3d[:, nbr_idx]                                # [T, P, NB]
    nbr_ok = jnp.moveaxis(nbr_ok, 0, 2) & nbr_valid[:, :, None] \
        & order_valid[None, None, :]
    return dt.TriangulationInputs(
        obs=obs, track_valid=track, nbr_pos=nbr_pos, nbr_valid=nbr_ok,
        cand_valid=candidates)


def assemble_triangulation_inputs(state: SlamState, config: Config):
    """Candidate selection + deformable-input assembly (shared with the
    profiling harness). Returns (candidates [P], compacted inputs [C],
    cand_sel [C], chronological order, order_valid, buffer poses [T])."""
    last = _last_snapshot_index(state)
    candidates = (state.tb_valid[last]
                  & state.tb_tracked[last] & ~state.tb_with3d[last]
                  & state.slot_used & ~state.has_3d)

    nbr_idx, nbr_valid, nbr_ok = _closest_mapped_neighbors(state, config)
    candidates = candidates & nbr_ok

    order, order_valid = _chronological(state)
    inputs = _deformable_inputs(state, config, order, order_valid, nbr_idx,
                                nbr_valid, candidates)
    poses = se3.index(state.tb_pose, order)

    # Compact the candidate axis (fixed budget, mapping work scales with it).
    C = min(config.max_triangulation_candidates, candidates.shape[0])
    _, cand_sel = jax.lax.top_k(jnp.where(candidates, 1.0, 0.0), C)
    inputs_c = jax.tree.map(lambda x: x[cand_sel], inputs)
    return candidates, inputs_c, cand_sel, order, order_valid, poses


def landmark_triangulation(state: SlamState, cam, config: Config) -> SlamState:
    """Dual-path triangulation with the 1.5x majority vote (mapping.cc:65-257).

    The deformable path is the expensive one (per-candidate dense LM), so
    candidates are compacted into ``max_triangulation_candidates`` slots
    before it runs and results scattered back afterwards.
    """
    (candidates, inputs_c, cand_sel, order, order_valid,
     poses) = assemble_triangulation_inputs(state, config)

    X_rigid, ok_rigid = _rigid_triangulation(state, cam, config, order,
                                             order_valid, candidates)
    X_def_c, ok_def_c = dt.deformable_triangulate(cam, inputs_c, poses,
                                                  config.rad_per_pixel)
    P = candidates.shape[0]
    X_def = jnp.zeros((P, 3), X_def_c.dtype).at[cand_sel].set(X_def_c)
    ok_def = jnp.zeros(P, bool).at[cand_sel].set(ok_def_c)
    ok_def = ok_def & candidates

    n_rigid = jnp.sum(ok_rigid.astype(jnp.int32))
    n_def = jnp.sum(ok_def.astype(jnp.int32))
    use_rigid = n_rigid > (1.5 * n_def)
    use_def = n_def >= (1.5 * n_rigid)

    insert = jnp.where(use_rigid, ok_rigid,
                       jnp.where(use_def, ok_def, jnp.zeros_like(ok_def)))
    X_new = jnp.where(use_rigid, X_rigid, X_def)

    positions = jnp.where(insert[:, None], X_new, state.positions)
    status = jnp.where(insert, klt.JUST_TRIANGULATED, state.status)
    has_3d = state.has_3d | insert

    # Star edges to all current landmarks (mapping.cc:238-257): the reference
    # connects each new landmark to every TRACKED_WITH_3D/JUST_TRIANGULATED
    # mappoint in the frame.
    current = state.slot_used & (
        (status == klt.TRACKED_WITH_3D) | (status == klt.JUST_TRIANGULATED))
    graph = graph_mod.add_edges(state.graph, positions, insert,
                                current & ~insert)

    return state._replace(positions=positions, status=status, has_3d=has_3d,
                          graph=graph)


# ---------------------------------------------------------------------------
# Bundle adjustment
# ---------------------------------------------------------------------------

def keyframe_mapping(state: SlamState, cam, config: Config) -> SlamState:
    """LocalDeformableBundleAdjustment over the last <= 5 keyframes plus the
    tracking-frame refresh (mapping.cc:36-58, 266-270)."""
    K = state.kf_valid.shape[0]
    W = config.ba_window

    # Window = the W newest valid keyframe slots (chronological).
    key = jnp.where(state.kf_valid, state.kf_id, -1)
    order = jnp.argsort(-key)[:W]            # newest first
    order = order[::-1]                      # oldest -> newest
    win_valid = state.kf_valid[order]
    n_win = jnp.sum(win_valid.astype(jnp.int32))

    poses0 = se3.index(state.kf_pose, order)
    L0 = state.kf_positions[order]
    obs = state.kf_keypoints[order]
    obs_valid = state.kf_obs[order] & win_valid[:, None]

    eligible = jnp.any(obs_valid, axis=0)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = graph_mod.top_k_neighbors(
        state.graph, eligible, config.regularizers_per_point)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                    nbr_valid & eligible[:, None])
    # Compact to the live top-weight subset: halves every [E, P] selector
    # matmul of the BA (and the kf-sharded variant sees the same table, so
    # their parity is preserved).
    pairs = pd.compact_pairs(pairs, L0.shape[1], eligible)

    problem = ba.BAProblem(obs=obs, obs_valid=obs_valid, kf_valid=win_valid,
                           pairs=pairs, scale=state.scale)
    poses1, L1 = ba.local_deformable_ba(cam, poses0, L0, problem,
                                        cg_iters=config.ba_cg_iters)

    # The reference requires >= 3 KFs in the window (g2o_optimization.cc:922).
    run = n_win >= 3
    poses1 = jax.tree.map(lambda a, b: jnp.where(run, a, b), poses1, poses0)
    L1 = jnp.where(run, L1, L0)

    kf_pose = se3.SE3(state.kf_pose.q.at[order].set(poses1.q),
                      state.kf_pose.t.at[order].set(poses1.t))
    kf_positions = state.kf_positions.at[order].set(L1)

    # UpdateTrackingFrameFromKeyFrame: the newest keyframe's optimized pose
    # and geometry refresh the live frame + landmark store (frame.cc:174-204).
    newest = order[-1]
    newest_obs = state.kf_obs[newest] & win_valid[-1]
    positions = jnp.where(newest_obs[:, None], kf_positions[newest],
                          state.positions)
    Tcw = jax.tree.map(
        lambda new, old: jnp.where(run, new, old),
        se3.index(kf_pose, newest), state.Tcw)

    return state._replace(kf_pose=kf_pose, kf_positions=kf_positions,
                          positions=positions, Tcw=Tcw)


@partial(jax.jit, static_argnames=("cam_kind", "config", "has_new_keyframe"))
@highest_precision
def _mapping_impl(state, cam_params, cam_kind, config, has_new_keyframe):
    cam = cameras.Camera(cam_params, cam_kind)
    if has_new_keyframe:
        return keyframe_mapping(state, cam, config)
    return landmark_triangulation(state, cam, config)


def do_mapping(state: SlamState, cam: cameras.Camera, config: Config,
               has_new_keyframe: bool) -> SlamState:
    """Mapping::DoMapping (mapping.cc:36-54)."""
    return _mapping_impl(state, cam.params, cam.kind, config, has_new_keyframe)
