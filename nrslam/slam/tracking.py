"""Per-frame tracking: data association, pose + deformation, point reuse,
keyframe policy.

Functional re-design of the reference front end
(/root/reference/modules/tracking/tracking.cc). Each step is a
(state, inputs) -> state transform over the SlamState pytree; the full frame
step jits as one XLA program (keyframe/non-keyframe are two specializations
since the cadence is known host-side, tracking.cc:332-348).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3, triangulation
from nrslam.ops import klt, shi_tomasi
from nrslam.slam import graph as graph_mod
from nrslam.slam import state as state_mod
from nrslam.slam.state import Config, SlamState
from nrslam.solver import pose_only, pose_deformation
from nrslam.utils import stats
from nrslam.utils.precision import highest_precision


def update_triangulated_points(state: SlamState) -> SlamState:
    """Promote JUST_TRIANGULATED -> TRACKED_WITH_3D (tracking.cc:508-527).

    The reference also copies the KLT photometric buffers into the MapPoint
    here; in the unified slot store they already live in ``state.refs``.
    """
    promote = state.slot_used & (state.status == klt.JUST_TRIANGULATED)
    return state._replace(
        status=jnp.where(promote, klt.TRACKED_WITH_3D, state.status))


def data_association(state: SlamState, pyramid, config: Config) -> SlamState:
    """KLT-track every usable slot into the new frame (tracking.cc:303-306)."""
    pts, status = klt.track(pyramid, state.refs, state.keypoints, state.status,
                            config.klt_config, min_ssim=config.klt_min_ssim,
                            use_initial_flow=True)
    return state._replace(keypoints=pts, status=status)


def track_camera_and_deformation(state: SlamState, cam, config: Config):
    """Motion-model seed -> pose-only -> joint pose+deformation
    (tracking.cc:291-330 + the post-processing inside the joint driver).

    Returns (state, lost_mask, flows) where lost_mask marks graph-connected
    mappoints that failed tracking this frame (drag-updated positions already
    applied, g2o_optimization.cc:476-556).
    """
    # Motion model seed (tracking.cc:309-312).
    T_seed = se3.compose(state.motion_model, state.Tcw)
    prev_Tcw = state.Tcw

    with3d = state_mod.tracked_with_3d(state)
    T_pose = pose_only.camera_pose_optimization(
        cam, T_seed, state.positions, state.keypoints, with3d)

    # Neighbor table for the regularizers.
    nbr_idx, nbr_w, nbr_d0, nbr_valid = graph_mod.top_k_neighbors(
        state.graph, with3d, config.regularizers_per_point)
    nbr_valid = nbr_valid & with3d[:, None]
    pairs = pose_deformation.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                                  nbr_valid)

    res = pose_deformation.pose_deformation_optimization(
        cam, T_pose, state.positions, state.keypoints, with3d, pairs,
        state.scale)

    # Accept deformations: position updates only for inlier+deform-ok points
    # (g2o_optimization.cc:419-447); outliers demote to TRACKED.
    accept = res.reproj_inlier & res.deform_ok
    positions = jnp.where(accept[:, None], state.positions + res.flows,
                          state.positions)
    status = jnp.where(with3d & ~accept, klt.TRACKED, state.status)

    # Graph maintenance for inliers; starved vertices demote to BAD
    # (g2o_optimization.cc:457-474).
    new_graph, good = graph_mod.update_vertices(
        state.graph, positions, res.reproj_inlier)
    starved = res.reproj_inlier & (
        good < (config.regularizers_per_point - 1) // 2)
    status = jnp.where(starved, klt.BAD, status)

    # Lost landmarks: graph-connected mappoints whose tracking failed
    # (g2o_optimization.cc:267-277) — drag them along neighbor flows.
    lost = (state.slot_used & state.has_3d
            & (status != klt.TRACKED_WITH_3D)
            & (status != klt.JUST_TRIANGULATED))
    drag = pose_deformation.lost_point_drag(
        res.flows, nbr_idx, nbr_w,
        nbr_valid & res.reproj_inlier[nbr_idx], state.scale)
    positions = jnp.where(lost[:, None], positions + drag, positions)

    state = state._replace(
        Tcw=res.Tcw,
        positions=positions,
        status=status,
        graph=new_graph,
        deformation_mag=res.median_deformation,
        motion_model=se3.compose(res.Tcw, se3.inverse(prev_Tcw)),
    )
    return state, lost


def point_reuse(state: SlamState, pyramid, cam, config: Config,
                lost_mask) -> SlamState:
    """Re-acquire lost / out-of-frame mappoints (tracking.cc:394-505).

    Projects every candidate mappoint, runs a 2-level KLT from the stored
    photometric patches at the projected seed, and re-inserts points whose
    tracked position agrees with the projection (chi2 5.99 gate).
    """
    h, w = pyramid[0][0].shape
    usable_now = klt.is_usable(state.status) & state.slot_used

    Xc = se3.apply(state.Tcw, state.positions)
    proj = cameras.project(cam, Xc)
    in_image = ((Xc[..., 2] > 0)
                & (proj[:, 0] >= 0) & (proj[:, 0] < w)
                & (proj[:, 1] >= 0) & (proj[:, 1] < h)
                & jnp.isfinite(proj).all(axis=-1))
    # The reference's candidate set is lost_mask plus the not-in-frame
    # mappoints whose projection lands inside the image; both are subsets of
    # "has 3D but not currently usable", filtered to in-image seeds.
    del lost_mask
    candidates = state.slot_used & state.has_3d & ~usable_now & in_image

    # 2-level KLT (the reference builds a maxLevel=1 tracker, tracking.cc:423).
    reuse_cfg = config.klt_config._replace(max_level=1)
    reuse_refs = state.refs.level_slice(2)
    seeds = jnp.where(candidates[:, None], proj, state.keypoints)
    seed_status = jnp.where(candidates, klt.TRACKED_WITH_3D,
                            jnp.int32(state_mod.NOT_IN_FRAME))
    pts, st = klt.track(pyramid[:2], reuse_refs, seeds, seed_status,
                        reuse_cfg, min_ssim=config.klt_min_ssim_reuse,
                        use_initial_flow=True)

    err = triangulation.squared_reprojection_error(proj, pts)
    reacquired = candidates & (st == klt.TRACKED_WITH_3D) & (err <= 5.99)

    return state._replace(
        keypoints=jnp.where(reacquired[:, None], pts, state.keypoints),
        status=jnp.where(reacquired, klt.TRACKED_WITH_3D, state.status))


def create_keyframe(state: SlamState, pyramid, mask, config: Config) -> SlamState:
    """Keyframe insertion: extract new features, snapshot the KF, refresh the
    KLT reference for every usable slot (tracking.cc:350-392).
    """
    img = pyramid[0][0]
    usable = klt.is_usable(state.status) & state.slot_used

    # Occupied map for the NMS poisoning (shi_tomasi.cc:90-99).
    h, w = img.shape
    occ = jnp.zeros((h, w), bool)
    yy = jnp.clip(jnp.round(state.keypoints[:, 1]).astype(jnp.int32), 0, h - 1)
    xx = jnp.clip(jnp.round(state.keypoints[:, 0]).astype(jnp.int32), 0, w - 1)
    occ = occ.at[yy, xx].max(usable)

    xy, det_valid, _ = shi_tomasi.detect(
        img, config.max_new_keypoints, nms_radius=config.nms_radius,
        mask=mask, occupied=occ)

    # Allocate free slots for the new features. Slots whose feature died are
    # recycled (their graph edges are dropped).
    dead = state.slot_used & ~usable & ~state.has_3d
    slot_used = state.slot_used & ~dead
    free_priority = jnp.where(~slot_used, 1.0, 0.0)
    _, slot_idx = jax.lax.top_k(free_priority, config.max_new_keypoints)
    can_place = (~slot_used)[slot_idx] & det_valid

    new_ids = state.next_track_id + jnp.cumsum(can_place.astype(jnp.int32)) - 1
    track_id = state.track_id.at[slot_idx].set(
        jnp.where(can_place, new_ids, state.track_id[slot_idx]))
    slot_used = slot_used.at[slot_idx].max(can_place)
    keypoints = state.keypoints.at[slot_idx].set(
        jnp.where(can_place[:, None], xy, state.keypoints[slot_idx]))
    status = jnp.where(dead, state_mod.NOT_IN_FRAME, state.status)
    status = status.at[slot_idx].set(
        jnp.where(can_place, klt.TRACKED, status[slot_idx]))
    has_3d = state.has_3d.at[slot_idx].set(
        jnp.where(can_place, False, state.has_3d[slot_idx]))

    graph = graph_mod.remove_landmarks(state.graph, dead)

    state = state._replace(
        slot_used=slot_used, track_id=track_id, keypoints=keypoints,
        status=status, has_3d=has_3d, graph=graph,
        next_track_id=state.next_track_id
        + jnp.sum(can_place.astype(jnp.int32)))

    # Snapshot the keyframe (TRACKED_WITH_3D observations).
    state = state_mod.insert_keyframe(state)

    # Refresh the KLT reference for all usable slots (SetKLTReference).
    usable = klt.is_usable(state.status) & state.slot_used
    refs = klt.set_reference(pyramid, state.keypoints, usable,
                             config.klt_config, mask=mask)
    return state._replace(refs=refs)


class FrameResult(NamedTuple):
    n_tracked_3d: jnp.ndarray
    lost: jnp.ndarray  # tracking collapse (reference exit()s, tracking.cc:97)


@partial(jax.jit, static_argnames=("cam_kind", "config", "make_keyframe"))
@highest_precision
def _process_frame_impl(state, pyramid, mask, cam_params, cam_kind, config,
                        make_keyframe):
    cam = cameras.Camera(cam_params, cam_kind)
    state = update_triangulated_points(state)
    state = data_association(state, pyramid, config)
    state, lost_mask = track_camera_and_deformation(state, cam, config)
    state = point_reuse(state, pyramid, cam, config, lost_mask)

    n3d = jnp.sum(state_mod.tracked_with_3d(state).astype(jnp.int32))
    if make_keyframe:
        state = create_keyframe(state, pyramid, mask, config)
    state = state_mod.insert_temporal_snapshot(state)
    # Latch the collapse on device (reference checks <10 on host and exits,
    # tracking.cc:97-99). system.frame_step freezes the state once latched.
    lost = state.lost | (n3d < config.min_tracked_exit)
    state = state._replace(lost=lost)
    return state, FrameResult(n_tracked_3d=n3d, lost=lost)


def process_frame(state: SlamState, pyramid, mask, cam: cameras.Camera,
                  config: Config, make_keyframe: bool):
    """One tracking step (Tracking::TrackImage steady state, tracking.cc:72-112)."""
    return _process_frame_impl(state, pyramid, mask, cam.params, cam.kind,
                               config, make_keyframe)
