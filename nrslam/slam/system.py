"""System facade: the per-frame entry point wiring preprocessing,
initialization, tracking, and mapping.

Functional re-design of /root/reference/modules/SLAM/system.{h,cc}. The
public surface mirrors the reference:

- ``System.track_image(rgb_or_gray)``            (system.cc:113-132)
- ``System.track_image_with_depth(img, depth)``  (system.cc:162-187) — also
  runs the depth-RMSE evaluator on tracked frames.

Host-side responsibilities are only sequencing and the keyframe cadence; all
per-frame math is jitted device code over the SlamState pytree.

Note: the reference computes a CLAHE image every frame but tracks on the raw
grayscale (the CLAHE output only feeds visualization — system.cc:113-132
passes ``im_gray`` to Tracking; ``im_clahe`` is never consumed by the math
path). ``apply_clahe`` is therefore off by default here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nrslam.eval import evaluator as evaluator_mod
from nrslam.geometry import cameras, se3
from nrslam.ops import image as image_ops
from nrslam.ops import klt
from nrslam.slam import graph as graph_mod
from nrslam.slam import initializer as init_mod
from nrslam.slam import mapping as mapping_mod
from nrslam.slam import state as state_mod
from nrslam.slam import tracking as tracking_mod
from nrslam.slam.state import Config
from nrslam.utils import stats
from nrslam.utils.precision import highest_precision


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("config",))
@highest_precision
def bootstrap_map(state, result: init_mod.InitializationResult, pyramid,
                  config: Config):
    """Create the initial map from a successful rigid initialization.

    Tracking::MonocularMapInitialization (tracking.cc:136-214): scale to
    median depth 3, create mappoints + two keyframes (reference at identity,
    current at the recovered pose), all-pairs deformation graph with sigma =
    3 * scaled depth std, and set the KLT reference on the current image.
    """
    P = config.max_points
    ok = result.point_ok
    depths = result.landmarks[:, 2]
    median_depth = stats.masked_median(depths, ok)
    scale = 3.0 / median_depth
    sigma_scaled = stats.masked_sigma(depths, ok) * scale

    # Take up to P initialized points (priority by validity).
    _, sel = jax.lax.top_k(jnp.where(ok, 1.0, 0.0), P)
    sel_ok = ok[sel]

    positions = result.landmarks[sel] * scale
    Tcw = se3.SE3(result.Tcw.q, result.Tcw.t * scale)

    state = state._replace(
        slot_used=sel_ok,
        track_id=jnp.where(sel_ok, result.track_id[sel], -1),
        has_3d=sel_ok,
        positions=jnp.where(sel_ok[:, None], positions, 0.0),
        keypoints=jnp.where(sel_ok[:, None], result.cur_keypoints[sel], 0.0),
        status=jnp.where(sel_ok, klt.TRACKED_WITH_3D,
                         state_mod.NOT_IN_FRAME).astype(jnp.int32),
        scale=scale,
        next_track_id=jnp.max(jnp.where(sel_ok, result.track_id[sel], -1)) + 1,
    )

    # Reference keyframe (identity pose, reference keypoints).
    ref_view = state._replace(
        Tcw=se3.identity(),
        keypoints=jnp.where(sel_ok[:, None], result.ref_keypoints[sel], 0.0))
    state = state_mod.insert_keyframe(ref_view)._replace(
        Tcw=Tcw, keypoints=state.keypoints)
    state = state_mod.insert_keyframe(state)

    # All-pairs graph (map.cc:139-167) with sigma = 3 * sigma_scaled.
    state = state._replace(graph=graph_mod.initialize(
        state.graph, state.positions, sel_ok,
        jnp.maximum(3.0 * sigma_scaled, 1e-3)))

    # KLT reference on the current image (tracking.cc:202-213).
    refs = klt.set_reference(pyramid, state.keypoints, sel_ok,
                             config.klt_config)
    state = state._replace(refs=refs)

    state = state_mod.insert_temporal_snapshot(state)
    return state


def bootstrap_map_stereo(state, keypoints, landmarks, point_ok, track_ids,
                         pyramid, config: Config,
                         graph_sigma: float = 10.5):
    """Create the initial map from stereo-triangulated landmarks.

    Tracking::StereoMapInitialization (tracking.cc:216-289): landmarks come
    metric from a stereo matcher (optionally DBSCAN-filtered by the caller),
    scale is 1, the graph sigma is the stereo default 10.5, and a single
    keyframe seeds the map.
    """
    P = config.max_points
    _, sel = jax.lax.top_k(jnp.where(point_ok, 1.0, 0.0), P)
    sel_ok = point_ok[sel]

    state = state._replace(
        slot_used=sel_ok,
        track_id=jnp.where(sel_ok, track_ids[sel], -1),
        has_3d=sel_ok,
        positions=jnp.where(sel_ok[:, None], landmarks[sel], 0.0),
        keypoints=jnp.where(sel_ok[:, None], keypoints[sel], 0.0),
        status=jnp.where(sel_ok, klt.TRACKED_WITH_3D,
                         state_mod.NOT_IN_FRAME).astype(jnp.int32),
        scale=jnp.float32(1.0),
        next_track_id=jnp.max(jnp.where(sel_ok, track_ids[sel], -1)) + 1,
    )
    state = state._replace(graph=graph_mod.initialize(
        state.graph, state.positions, sel_ok, graph_sigma))
    refs = klt.set_reference(pyramid, state.keypoints, sel_ok,
                             config.klt_config)
    state = state._replace(refs=refs)
    state = state_mod.insert_keyframe(state)
    state = state_mod.insert_temporal_snapshot(state)
    return state


NOT_INITIALIZED = "NOT_INITIALIZED"
TRACKING = "TRACKING"
LOST = "LOST"


@_partial(jax.jit, static_argnames=("cam_kind", "config", "make_keyframe"))
@highest_precision
def _fused_frame_impl(state, gray, mask, cam_params, cam_kind, config,
                      make_keyframe):
    """Pyramid + tracking + mapping as ONE XLA program.

    Fusing the whole steady-state frame into a single jit removes two
    dispatch round-trips per frame and lets XLA overlap the mapping work
    with the tail of tracking. Two specializations exist (keyframe /
    non-keyframe), mirroring the reference's host-known cadence
    (tracking.h:46).
    """
    old = state
    pyramid = klt.build_pyramid(gray, config.klt_config)
    state, result = tracking_mod._process_frame_impl(
        state, pyramid, mask, cam_params, cam_kind, config, make_keyframe)
    state = mapping_mod._mapping_impl(
        state, cam_params, cam_kind, config, has_new_keyframe=make_keyframe)
    # Device-side LOST freeze: once the collapse latch is set, every later
    # frame is a no-op on the state (the reference exit(0)s at the collapse
    # frame, tracking.cc:97-99). This keeps reference-exact semantics even
    # when the host only materializes the check every `lost_check_every`
    # frames — the <=N-1 frames between collapse and discovery neither
    # corrupt the map nor advance the rings.
    state = jax.tree.map(_partial(jnp.where, old.lost), old, state)
    result = result._replace(
        n_tracked_3d=jnp.where(old.lost, 0, result.n_tracked_3d),
        lost=old.lost | result.lost)
    return state, result


def frame_step(state, gray, mask, cam: cameras.Camera, config: Config,
               make_keyframe: bool):
    """One fused steady-state SLAM frame (System::TrackImage after init)."""
    return _fused_frame_impl(state, gray, mask, cam.params, cam.kind, config,
                             make_keyframe)


class System:
    """Stateful driver (host orchestration over jitted device steps)."""

    def __init__(self, cam: cameras.Camera, config: Config = Config(),
                 init_config: Optional[init_mod.InitializerConfig] = None,
                 masker=None, apply_clahe: bool = False, seed: int = 4,
                 auto_reinitialize: bool = False,
                 lost_check_every: int = 1,
                 init_check_every: int = 1):
        self.cam = cam
        self.config = config
        self.init_config = init_config or init_mod.InitializerConfig(
            rad_per_pixel=config.rad_per_pixel,
            nms_radius=config.nms_radius,
            klt_min_ssim=config.klt_min_ssim_init)
        self.masker = masker
        self.apply_clahe = apply_clahe
        self.auto_reinitialize = auto_reinitialize
        self.status = NOT_INITIALIZED
        self.state = None
        self.init_state = None
        self._frames_since_kf = 0
        self._made_kf_last_frame = False
        # Materialize the LOST check only every N frames: bool() on a
        # device scalar waits for the frame program, which stops the host
        # from queueing the next frame behind it (the reference checks its
        # <10-points exit per frame on host, tracking.cc:97-99, but its
        # state already lives on host).
        self.lost_check_every = max(1, int(lost_check_every))
        # Same deferral for the init phase: each init frame is ONE jitted
        # program (init_mod.init_step) whose success flag is held
        # un-materialized; flags batch-materialize every N frames. N > 1
        # trades up to N-1 tracked frames at the init->tracking handoff for
        # zero per-frame syncs (the successful frame's own pyramid/result
        # seed the map, so the map itself is exact).
        self.init_check_every = max(1, int(init_check_every))
        self._init_ring = []
        self._init_count = 0
        self._frame_count = 0
        self._key = jax.random.PRNGKey(seed)  # reference fixes srand(4)
        self.evaluator = evaluator_mod.FrameEvaluator()
        self._image_shape = None
        self._ones_mask = None

    # -- preprocessing ------------------------------------------------------

    @staticmethod
    @_partial(jax.jit, static_argnames=("rgb", "clahe"))
    @highest_precision
    def _preprocess_impl(img, rgb, clahe):
        if rgb:
            img = image_ops.rgb_to_gray(img)
        img = img.astype(jnp.float32)
        if clahe:
            img = image_ops.clahe(img)
        return img

    def _preprocess(self, img):
        # One jitted dispatch instead of a chain of eager ops.
        img = jnp.asarray(img)
        return System._preprocess_impl(img, img.ndim == 3, self.apply_clahe)

    def _mask(self, gray):
        if self.masker is None:
            # Cache the trivial mask: rebuilding it is a per-frame dispatch.
            if (self._ones_mask is None
                    or self._ones_mask.shape != gray.shape):
                self._ones_mask = jnp.ones(gray.shape, bool)
            return self._ones_mask
        return self.masker(gray)

    # -- main entry points --------------------------------------------------

    def track_image(self, img) -> dict:
        gray = self._preprocess(img)
        if self._image_shape is None:
            self._image_shape = gray.shape
        mask = self._mask(gray)

        if self.status == NOT_INITIALIZED:
            pyramid = klt.build_pyramid(gray, self.config.klt_config)
            self._initialize(pyramid, mask)
            return {"status": self.status}

        make_kf = self._frames_since_kf >= self.config.keyframe_every
        self._frames_since_kf = 0 if make_kf else self._frames_since_kf + 1

        # Pyramid + tracking + mapping (system.cc:113-132) fused in one jit.
        self.state, frame_result = frame_step(
            self.state, gray, mask, self.cam, self.config, make_kf)
        self._made_kf_last_frame = make_kf
        self._frame_count += 1

        # n_tracked_3d is ALWAYS an un-materialized device scalar (int32);
        # callers needing a host int should int() it themselves. The LOST
        # decision reads the device-side collapse latch (state.lost), which
        # freezes the pipeline the moment tracking collapses, so deferring
        # the host materialization to every `lost_check_every` frames delays
        # only the *surfacing* of LOST, not its semantics.
        if self._frame_count % self.lost_check_every == 0:
            if bool(frame_result.lost):
                # The reference exit(0)s here (tracking.cc:97-99); we surface
                # LOST, and optionally recover by re-initializing a fresh map
                # (relocalization-or-reinit policy, SURVEY.md §5).
                if self.auto_reinitialize:
                    self.status = NOT_INITIALIZED
                    self.state = None
                    self.init_state = None
                else:
                    self.status = LOST
        return {"status": self.status,
                "n_tracked_3d": frame_result.n_tracked_3d,
                "keyframe": make_kf}

    def track_image_with_depth(self, img, depth) -> dict:
        out = self.track_image(img)
        if self.status == TRACKING and self.state is not None:
            rmse = self.evaluator.evaluate(self.state, self.cam,
                                           jnp.asarray(depth))
            out["depth_rmse"] = rmse
        return out

    def track_image_with_stereo(self, img_left, img_right,
                                bf: float = 0.0) -> dict:
        """Stereo variant (system.cc:134-160): track on the left image; the
        right image provides stereo ground truth for evaluation. The
        reference compiles the stereo evaluator call out (`if (false && ...)`,
        system.cc:152-157); here it runs when ``bf`` is provided."""
        out = self.track_image(img_left)
        if bf > 0 and self.status == TRACKING and self.state is not None:
            from nrslam.ops import stereo as stereo_ops
            gray_l = self._preprocess(img_left)
            gray_r = self._preprocess(img_right)
            valid = (self.state.slot_used
                     & (self.state.status == 0))  # TRACKED_WITH_3D
            gt3d, ok = stereo_ops.stereo_pattern_matching(
                self.cam, bf, gray_l, gray_r, self.state.keypoints, valid)
            est = se3.apply(self.state.Tcw, self.state.positions)[..., 2]
            # Stereo GT is noisy (NCC matches): the reference pre-filters by
            # 1.5*IQR on |est-gt| and aligns with a 0.9 inlier fraction
            # (frame_evaluator.cc:138-162), vs no-filter/0.95 for
            # precomputed depth.
            out["stereo_rmse"] = float(
                evaluator_mod._scale_aligned_rmse(
                    est, gt3d[..., 2], ok, inlier_fraction=0.9,
                    iqr_reject=True))
        return out

    # -- initialization -----------------------------------------------------

    def _initialize(self, pyramid, mask):
        cfg = self.init_config
        kcfg = self.config.klt_config
        if self.init_state is None:
            self.init_state = init_mod.reset(pyramid, mask, jnp.int32(0),
                                             kcfg, cfg)
            self._init_ring = []
            self._init_count = 0
            return

        # One fused jitted program per init frame; no host materialization
        # here (monocular_map_initializer.cc:100-133 — tracking, the
        # min-matches/window reset decision and the rigid attempt).
        # fold_in (not split): split would chain a tiny device program per
        # frame through the key.
        sub = jax.random.fold_in(self._key, self._init_count)
        self.init_state, result = init_mod.init_step(
            self.init_state, pyramid, mask, sub, self.cam.params,
            self.cam.kind, kcfg, cfg)
        self._init_ring.append((result, pyramid))
        self._init_count += 1
        if self._init_count % self.init_check_every:
            return

        # Batched success check: ONE device fetch for the whole window.
        flags = jax.device_get(
            jnp.stack([r.success for r, _ in self._init_ring]))
        ring = self._init_ring
        self._init_ring = []
        for ok, (result, pyr) in zip(flags, ring):
            if ok:
                state = state_mod.empty_state(self.config, self._image_shape)
                self.state = bootstrap_map(state, result, pyr, self.config)
                self.status = TRACKING
                self.init_state = None
                self._frames_since_kf = 0
                return

    # -- introspection ------------------------------------------------------

    def trajectory_pose(self):
        return None if self.state is None else self.state.Tcw

    def map_points(self):
        if self.state is None:
            return np.zeros((0, 3))
        used = np.asarray(self.state.slot_used & self.state.has_3d)
        return np.asarray(self.state.positions)[used]
