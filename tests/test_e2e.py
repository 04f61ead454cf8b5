"""End-to-end integration test on the synthetic deformable sequence.

Reproduces the reference's TrackImageWithDepth flow (system.cc:162-187) —
monocular init, tracking, triangulation, BA — and checks the depth-RMSE
machinery (frame_evaluator.cc) stays within bounds, the de-facto integration
standard of the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.datasets import synthetic
from nrslam.slam import system as system_mod
from nrslam.slam.state import Config


def run_sequence(deform_amp, n_frames=24, max_points=256, **system_kwargs):
    scene = synthetic.SceneConfig(deform_amp=deform_amp)
    seq = synthetic.SyntheticSequence(scene, n_frames=n_frames)
    cam = synthetic.camera(scene)
    config = Config(max_points=max_points, max_new_keypoints=96,
                    rad_per_pixel=1.0 / scene.fx)
    init_config = system_mod.init_mod.InitializerConfig(
        max_features=384, min_matches=60, min_triangulated=50,
        rad_per_pixel=1.0 / scene.fx, n_hypotheses=48)
    sys = system_mod.System(cam, config, init_config, **system_kwargs)

    results = []
    for i in range(n_frames):
        gray, depth, Tcw_gt = seq.get_frame(i)
        out = sys.track_image_with_depth(gray, depth)
        out["gt_pose"] = Tcw_gt
        if sys.status == system_mod.TRACKING and sys.state is not None:
            out["est_pose"] = sys.state.Tcw
        results.append(out)
        if sys.status == system_mod.LOST:
            break
    return sys, results


@pytest.mark.slow
def test_rigid_sequence_tracks_and_reconstructs():
    sys, results = run_sequence(deform_amp=0.0)
    assert sys.status == system_mod.TRACKING, sys.status
    rmses = [float(r["depth_rmse"]) for r in results if "depth_rmse" in r]
    assert len(rmses) >= 10, f"only {len(rmses)} tracked frames"
    # Scene depth ~3 units. Measured median 0.071 under the test settings
    # (CPU); the gate sits ~1.4x above so a 1.5x accuracy regression trips.
    assert np.median(rmses) < 0.10, rmses

    # Trajectory check: ATE (Sim3-aligned, monocular scale) against GT poses
    # over the tracked frames.
    from nrslam.eval import metrics
    est = [r["est_pose"] for r in results if "est_pose" in r]
    gt = [r["gt_pose"] for r in results if "est_pose" in r]
    assert len(est) >= 10
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    # GT translation magnitude over the clip is ~0.3 units; measured ATE
    # 0.0006 (CPU) — gate at ~3x measured.
    assert ate < 0.002, ate


@pytest.mark.slow
def test_deferred_init_check_matches_per_frame_check():
    """init_check_every > 1 (the CLI's default): the
    deferred handoff bootstraps from the success frame's OWN pyramid and
    result, so the map is the per-frame-check map exactly — only the
    handoff frame index may shift by up to N-1 skipped frames."""
    sys1, res1 = run_sequence(deform_amp=0.0)
    sys4, res4 = run_sequence(deform_amp=0.0, init_check_every=4)
    assert sys1.status == system_mod.TRACKING
    assert sys4.status == system_mod.TRACKING
    r1 = [float(r["depth_rmse"]) for r in res1 if "depth_rmse" in r]
    r4 = [float(r["depth_rmse"]) for r in res4 if "depth_rmse" in r]
    # At most N-1 fewer tracked frames; same map quality.
    assert len(r1) - len(r4) <= 3, (len(r1), len(r4))
    assert abs(np.median(r1) - np.median(r4)) < 0.02, (np.median(r1),
                                                       np.median(r4))


@pytest.mark.slow
def test_deforming_sequence_tracks():
    # Deformation delays the rigid init (epipolar/parallax gates need more
    # baseline), so allow a longer warm-up horizon.
    sys, results = run_sequence(deform_amp=0.03, n_frames=36)
    assert sys.status == system_mod.TRACKING, sys.status
    rmses = [float(r["depth_rmse"]) for r in results if "depth_rmse" in r]
    assert len(rmses) >= 10
    # Measured median 0.163 under the test settings (CPU; deformation makes
    # the init timing and depth observability run-sensitive); gate ~1.25x
    # above measured.
    assert np.median(rmses) < 0.20, rmses

    # Deforming-run trajectory gate. Monocular Sim3-aligned; measured 0.024
    # over a 0.256-unit sweep (CPU) — ~40x the rigid run's 0.0006, because camera
    # motion at deformation timescales is partially absorbed as map
    # deformation (a genuine gauge ambiguity of deformable SLAM; the
    # reference's own evaluator measures only depth RMSE for this reason,
    # frame_evaluator.cc). Gate ~3x measured: a real trajectory regression
    # trips, the gauge-level error does not.
    from nrslam.eval import metrics
    est = [r["est_pose"] for r in results if "est_pose" in r]
    gt = [r["gt_pose"] for r in results if "est_pose" in r]
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    assert ate < 0.07, ate
