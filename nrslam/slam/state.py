"""The SLAM state pytree: fixed-capacity landmark slots, keyframe ring,
temporal buffer, deformation graph.

Functional replacement for the reference's pointer-graph Map/Frame/KeyFrame/
MapPoint/TemporalBuffer (modules/map/*). One fixed pool of P landmark slots
unifies the reference's per-frame keypoint vectors and its mappoint hash map:

- a slot is allocated when a feature is extracted (it IS the feature track),
- gains 3D when triangulated (MapPoint with position history head here),
- keeps carrying its KLT reference patches (MapPoint::PhotometricInformation)
  so PointReuse can re-acquire it after tracking loss,
- and is recycled when dead.

All pipeline steps are (state, inputs) -> state transforms over this pytree;
there is no shared mutable map and hence none of the reference's
visualizer-vs-tracker races (SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import se3
from nrslam.ops import klt
from nrslam.slam import graph as graph_mod

# Sentinel status for slots with no current-frame observation. The reference
# has no such code because its Frame only holds in-frame keypoints; slots make
# it explicit. Any value > BAD_FEATURE works with klt.is_usable.
NOT_IN_FRAME = 6


class Config(NamedTuple):
    """Capacities + the knobs the reference hardcodes at construction sites
    (system.cc:37-90, tracking.cc:34-61, map.cc:27-31), promoted to config."""

    max_points: int = 512          # landmark slot capacity
    max_keyframes: int = 8         # keyframe ring capacity (BA window uses 5)
    ba_window: int = 5             # g2o_optimization.cc:894
    temporal_window: int = 20      # system.cc:42
    klt_win: int = 21
    klt_levels: int = 5            # maxLevel 4
    klt_iters: int = 10
    klt_epsilon: float = 1e-4
    klt_min_eig: float = 1e-4
    klt_min_ssim: float = 0.7      # tracking
    klt_min_ssim_init: float = 0.5 # initializer / stereo
    klt_min_ssim_reuse: float = 0.75  # PointReuse (tracking.cc:461)
    keyframe_every: int = 5        # tracking.h:46
    nms_radius: int = 7            # tracking.cc:35
    max_new_keypoints: int = 256   # per keyframe re-extraction
    regularizers_per_point: int = 11  # "> 10" loop => up to 11 edges
    graph_sigma: float = 10.5      # map.cc:28 (reset at init)
    rad_per_pixel: float = 0.002   # settings Camera.radiansPerPixel
    rigidity_threshold: float = 0.004  # mapping.cc:124
    min_tracked_exit: int = 10     # tracking.cc:97
    tri_min_neighbors_px: float = 20.0   # temporal_buffer queries (mapping.cc:71)
    tri_max_neighbors_px: float = 500.0
    tri_num_neighbors: int = 11    # "> 10" => 11
    max_triangulation_candidates: int = 128
    # Inner PCG depth of the keyframe-BA window solve. The reference's g2o
    # solves its normal equations exactly per LM step; with our block-Jacobi
    # PCG the window quality is LM-outer-loop limited, not CG-limited:
    # measured reproj RMSE is flat from ~12 trips (0.0622 @ 12 vs 0.0627 @
    # 32 on a K=5/P=768 noisy window; identical to 6 digits on a 70%-masked
    # one). 16 keeps margin and halves the dominant kf-frame BA cost.
    ba_cg_iters: int = 16

    @property
    def klt_config(self) -> klt.KLTConfig:
        return klt.KLTConfig(win=self.klt_win, max_level=self.klt_levels - 1,
                             max_iters=self.klt_iters, epsilon=self.klt_epsilon,
                             min_eig_threshold=self.klt_min_eig)


class SlamState(NamedTuple):
    # --- landmark slots ---
    slot_used: jnp.ndarray     # [P] bool
    track_id: jnp.ndarray      # [P] int32 feature-track id (keypoint class_id)
    has_3d: jnp.ndarray        # [P] bool (mappoint exists)
    positions: jnp.ndarray     # [P, 3] last world positions
    # --- current frame ---
    keypoints: jnp.ndarray     # [P, 2]
    status: jnp.ndarray        # [P] int32 LandmarkStatus / NOT_IN_FRAME
    Tcw: se3.SE3
    frame_id: jnp.ndarray      # int32 (next frame id, bumped at SetLastFrame)
    deformation_mag: jnp.ndarray  # median |flow| of the last joint solve
    # --- KLT photometric state per slot ---
    refs: klt.KLTRefs
    # --- deformation graph ---
    graph: graph_mod.GraphState
    # --- keyframe ring ---
    kf_valid: jnp.ndarray      # [K]
    kf_id: jnp.ndarray         # [K] int32
    kf_pose: se3.SE3           # [K]
    kf_keypoints: jnp.ndarray  # [K, P, 2]
    kf_obs: jnp.ndarray        # [K, P] bool (TRACKED_WITH_3D at creation)
    kf_positions: jnp.ndarray  # [K, P, 3]
    kf_next: jnp.ndarray       # int32 ring head
    # --- temporal buffer ring ---
    tb_valid: jnp.ndarray      # [T]
    tb_frame_id: jnp.ndarray   # [T] int32
    tb_pose: se3.SE3           # [T]
    tb_keypoints: jnp.ndarray  # [T, P, 2]
    tb_tracked: jnp.ndarray    # [T, P] bool (TRACKED or TRACKED_WITH_3D)
    tb_with3d: jnp.ndarray     # [T, P] bool (TRACKED_WITH_3D)
    tb_positions: jnp.ndarray  # [T, P, 3]
    tb_def_mag: jnp.ndarray    # [T]
    # --- scalars ---
    scale: jnp.ndarray         # global map scale
    next_track_id: jnp.ndarray  # int32 feature id counter
    motion_model: se3.SE3      # relative motion Tcw_t * Tcw_{t-1}^-1
    # Device-side tracking-collapse latch (reference: per-frame host check +
    # exit(0), tracking.cc:97-99). Once set, the fused frame step freezes the
    # whole state so deferred host checks (lost_check_every > 1) cannot run
    # the pipeline on a collapsed map — reference-exact semantics without a
    # per-frame host round trip.
    lost: jnp.ndarray          # bool scalar


def empty_state(config: Config, image_shape) -> SlamState:
    P = config.max_points
    K = config.max_keyframes
    T = config.temporal_window
    L = config.klt_levels
    W = config.klt_win
    f3 = jnp.zeros((P, 3), jnp.float32)
    refs = klt.KLTRefs(
        points=jnp.zeros((P, 2), jnp.float32),
        patch=jnp.zeros((P, L, W, W), jnp.float32),
        patch_grad=jnp.zeros((P, L, W, W, 2), jnp.float32),
        mean_i=jnp.zeros((P, L), jnp.float32),
        mean_i2=jnp.ones((P, L), jnp.float32),
        valid=jnp.zeros((P, L), bool),
    )
    return SlamState(
        slot_used=jnp.zeros(P, bool),
        track_id=jnp.full(P, -1, jnp.int32),
        has_3d=jnp.zeros(P, bool),
        positions=f3,
        keypoints=jnp.zeros((P, 2), jnp.float32),
        status=jnp.full(P, NOT_IN_FRAME, jnp.int32),
        Tcw=se3.identity(),
        frame_id=jnp.int32(0),
        deformation_mag=jnp.float32(0.0),
        refs=refs,
        graph=graph_mod.empty(P, config.graph_sigma),
        kf_valid=jnp.zeros(K, bool),
        kf_id=jnp.full(K, -1, jnp.int32),
        kf_pose=se3.identity((K,)),
        kf_keypoints=jnp.zeros((K, P, 2), jnp.float32),
        kf_obs=jnp.zeros((K, P), bool),
        kf_positions=jnp.zeros((K, P, 3), jnp.float32),
        kf_next=jnp.int32(0),
        tb_valid=jnp.zeros(T, bool),
        tb_frame_id=jnp.full(T, -1, jnp.int32),
        tb_pose=se3.identity((T,)),
        tb_keypoints=jnp.zeros((T, P, 2), jnp.float32),
        tb_tracked=jnp.zeros((T, P), bool),
        tb_with3d=jnp.zeros((T, P), bool),
        tb_positions=jnp.zeros((T, P, 3), jnp.float32),
        tb_def_mag=jnp.zeros(T, jnp.float32),
        scale=jnp.float32(1.0),
        next_track_id=jnp.int32(0),
        motion_model=se3.identity(),
        lost=jnp.array(False),
    )


def tracked_with_3d(state: SlamState) -> jnp.ndarray:
    return state.slot_used & (state.status == klt.TRACKED_WITH_3D)


def insert_temporal_snapshot(state: SlamState) -> SlamState:
    """Map::SetLastFrame + TemporalBuffer::InsertSnapshotFromFrame
    (map.cc:106-118, temporal_buffer.cc:28-56): snapshot the tracked slots and
    bump the frame id. Ring slot = frame_id % T.
    """
    T = state.tb_valid.shape[0]
    slot = state.frame_id % T
    tracked = state.slot_used & ((state.status == klt.TRACKED)
                                 | (state.status == klt.TRACKED_WITH_3D))
    with3d = state.slot_used & (state.status == klt.TRACKED_WITH_3D)
    return state._replace(
        tb_valid=state.tb_valid.at[slot].set(True),
        tb_frame_id=state.tb_frame_id.at[slot].set(state.frame_id),
        tb_pose=se3.SE3(state.tb_pose.q.at[slot].set(state.Tcw.q),
                        state.tb_pose.t.at[slot].set(state.Tcw.t)),
        tb_keypoints=state.tb_keypoints.at[slot].set(state.keypoints),
        tb_tracked=state.tb_tracked.at[slot].set(tracked),
        tb_with3d=state.tb_with3d.at[slot].set(with3d),
        tb_positions=state.tb_positions.at[slot].set(state.positions),
        tb_def_mag=state.tb_def_mag.at[slot].set(state.deformation_mag),
        frame_id=state.frame_id + 1,
    )


def insert_keyframe(state: SlamState) -> SlamState:
    """KeyFrame creation from the current frame (keyframe.cc:26-55)."""
    K = state.kf_valid.shape[0]
    slot = state.kf_next % K
    obs = tracked_with_3d(state)
    return state._replace(
        kf_valid=state.kf_valid.at[slot].set(True),
        kf_id=state.kf_id.at[slot].set(state.frame_id),
        kf_pose=se3.SE3(state.kf_pose.q.at[slot].set(state.Tcw.q),
                        state.kf_pose.t.at[slot].set(state.Tcw.t)),
        kf_keypoints=state.kf_keypoints.at[slot].set(state.keypoints),
        kf_obs=state.kf_obs.at[slot].set(obs),
        kf_positions=state.kf_positions.at[slot].set(state.positions),
        kf_next=state.kf_next + 1,
    )


def chronological_temporal_order(state: SlamState) -> jnp.ndarray:
    """Ring indices sorted oldest -> newest (invalid slots last)."""
    key = jnp.where(state.tb_valid, state.tb_frame_id, jnp.int32(2 ** 30))
    return jnp.argsort(key)


def allocate_slots(state: SlamState, n: int):
    """Find up to n free slot indices (free = unused)."""
    free = ~state.slot_used
    priority = jnp.where(free, 1.0, 0.0)
    _, idx = jax.lax.top_k(priority, n)
    ok = free[idx]
    return idx, ok
