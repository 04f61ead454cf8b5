"""Endurance e2e: 220 frames of deforming sequence with a forced tracking
collapse and automatic re-initialization.

The reference's apps loop over thousands of frames
(/root/reference/apps/endomapper.cc:60-70); prior tests topped out at ~40.
This run exercises what only long sequences reach:
- the 8-slot keyframe ring wrapping repeatedly (a KF every 5 frames),
- landmark slot recycling under continuous re-extraction as the camera
  sweeps onto new surface,
- the device-side LOST latch + auto_reinitialize recovery path (the
  reference exit(0)s at collapse, tracking.cc:97-99; SURVEY.md §5 makes
  recovery a first-class requirement),
- evaluator history over hundreds of frames (batched device_get path), and
- a full-trajectory ATE gate on the longest tracked segment.

The scene uses a gentler motion profile than the short e2e tests
(motion_rotation 0.001, motion_translation 0.008): the default profile's
twist grows linearly with time and the viewing geometry organically
degrades past ~100 frames — which is a property of the synthetic
trajectory, not of the pipeline. Occasional organic collapses still happen
late in the run; the asserts require the system to RECOVER from every one
(final status TRACKING), not that none occur.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.datasets import synthetic
from nrslam.eval import metrics
from nrslam.slam import system as system_mod
from nrslam.slam.state import Config

N_FRAMES = 220
BLACKOUT = range(100, 104)   # frames fed as black -> tracking collapse


@pytest.mark.slow
def test_endurance_long_sequence_with_reinit():
    scene = synthetic.SceneConfig(deform_amp=0.02, motion_rotation=0.001,
                                  motion_translation=0.008)
    seq = synthetic.SyntheticSequence(scene, n_frames=N_FRAMES)
    cam = synthetic.camera(scene)
    config = Config(max_points=192, max_new_keypoints=64,
                    rad_per_pixel=1.0 / scene.fx)
    init_config = system_mod.init_mod.InitializerConfig(
        max_features=384, min_matches=60, min_triangulated=50,
        rad_per_pixel=1.0 / scene.fx, n_hypotheses=48)
    sys = system_mod.System(cam, config, init_config,
                            auto_reinitialize=True, lost_check_every=5)

    statuses = []
    segments = [[]]   # (est, gt, rmse) tuples per tracking segment
    black = jnp.zeros((scene.height, scene.width), jnp.float32)
    for i in range(N_FRAMES):
        gray, depth, Tcw_gt = seq.get_frame(i)
        if i in BLACKOUT:
            gray = black
        out = sys.track_image_with_depth(gray, depth)
        statuses.append(sys.status)
        if sys.status == system_mod.NOT_INITIALIZED and segments[-1]:
            segments.append([])   # reinit -> new segment
        if (sys.status == system_mod.TRACKING and sys.state is not None
                and "depth_rmse" in out):
            rmse = float(out["depth_rmse"])
            # NaN marks a frame after the device-side collapse latch fired
            # (frozen state, excluded from the history too) — not a sample.
            if np.isfinite(rmse):
                segments[-1].append((sys.state.Tcw, Tcw_gt, rmse))

    # The blackout collapse was detected and recovered from, and every
    # later (organic) collapse was recovered from within the horizon a
    # recovery takes (~10 frames: LOST surfacing + re-init baseline). The
    # exact collapse frames are float-trajectory-sensitive (the suite's
    # 8-virtual-device mesh sums in a different order than a single
    # device), so the gate is "always recovers", not "never collapses".
    assert system_mod.NOT_INITIALIZED in statuses[100:], (
        "blackout did not trigger re-initialization")
    last_tracking = max(i for i, s in enumerate(statuses)
                        if s == system_mod.TRACKING)
    assert N_FRAMES - 1 - last_tracking <= 15, (
        f"no recovery after frame {last_tracking}: "
        f"{statuses[last_tracking:]}")

    # Substantial tracking on both sides of the blackout; the longest
    # segment alone inserts >= 12 keyframes (one per 5 frames), wrapping
    # the 8-slot keyframe ring.
    lens = [len(s) for s in segments if s]
    assert len(lens) >= 2, lens
    assert sum(lens) >= 140, lens
    longest = max(segments, key=len)
    assert len(longest) >= 60, lens

    # Slot recycling: fresh extraction kept minting track ids beyond the
    # slot capacity (slots are recycled, not leaked).
    state = sys.state if sys.state is not None else None
    if state is not None:
        assert int(state.next_track_id) > config.max_points, \
            int(state.next_track_id)

    # Depth accuracy holds over the whole run (per-segment warmup excluded;
    # deforming-scene gate as in test_e2e).
    for seg in (s for s in segments if len(s) >= 30):
        rmses = [r for _, _, r in seg[10:]]
        assert np.isfinite(rmses).all()
        assert np.median(rmses) < 0.20, np.median(rmses)

    # Full-trajectory gate on the longest segment, scaled to the ground-
    # truth travel: on a deforming scene the camera's oscillating motion is
    # partially absorbed as map deformation (gauge ambiguity — see
    # test_e2e's deforming gate), and the synthetic trajectory's
    # oscillation amplitude GROWS with time, so absolute ATE is dominated
    # by that gauge term (measured 0.32 over 0.79 units of travel, 41%).
    # The gate catches a trajectory that stops following the sweep; the
    # per-frame depth-RMSE gates above are the accuracy tripwire (the
    # reference's own metric, frame_evaluator.cc).
    est = [e for e, _, _ in longest]
    gt = [g for _, g, _ in longest]
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    centers = metrics.camera_centers(gt)
    travel = float(np.linalg.norm(np.diff(centers, axis=0), axis=-1).sum())
    assert ate < 0.25 * travel, (ate, travel)
    # Local consistency: 5-frame relative displacements stay accurate to
    # well under the per-step motion (measured RPE5 ~0.33 against a
    # per-5-frame oscillating displacement of ~0.5 at this amplitude).
    rpe = metrics.rpe_trans_rmse(est, gt, delta=5)
    assert rpe < ate * 1.5, (rpe, ate)

    # Evaluator history: post-loss frames were excluded, everything else
    # materialized in batched transfers.
    hist = sys.evaluator.rmse_history
    assert len(hist) >= sum(lens)
    assert np.isfinite(hist).all()
