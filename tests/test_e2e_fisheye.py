"""End-to-end tests with the Kannala-Brandt-8 fisheye camera (the Endomapper
configuration, settings.cc:93-122) — rigid, and deforming with a masker in
the loop (the actual Endomapper operating mode: KB8 + deformation + border
masking, apps/endomapper.cc + data/endomapper filters)."""

import numpy as np
import pytest

from nrslam.datasets import synthetic
from nrslam.geometry import cameras
from nrslam.ops import masking
from nrslam.slam import system as system_mod
from nrslam.slam.state import Config


def run_fisheye(deform_amp, n_frames, masker=None, height=240, width=320,
                max_points=256, max_new_keypoints=96):
    """Run the KB8 sequence; returns (system, per-frame depth RMSEs,
    (estimated, ground-truth) Tcw of the evaluated frames)."""
    scene = synthetic.SceneConfig(height=height, width=width,
                                  camera_kind=cameras.KB8,
                                  deform_amp=deform_amp)
    seq = synthetic.SyntheticSequence(scene, n_frames=n_frames)
    cam = synthetic.camera(scene)
    assert cam.kind == cameras.KB8
    config = Config(max_points=max_points,
                    max_new_keypoints=max_new_keypoints,
                    rad_per_pixel=1.0 / scene.fx)
    # The map bootstraps up to max_points of the initializer's features, so
    # the feature budget scales with the slot capacity (384 at P=256).
    init_config = system_mod.init_mod.InitializerConfig(
        max_features=3 * max_points // 2, min_matches=60, min_triangulated=50,
        rad_per_pixel=1.0 / scene.fx, n_hypotheses=48)
    sys = system_mod.System(cam, config, init_config, masker=masker)

    rmses, est, gt = [], [], []
    for i in range(n_frames):
        gray, depth, Tcw_gt = seq.get_frame(i)
        out = sys.track_image_with_depth(gray, depth)
        if "depth_rmse" in out:
            rmses.append(float(out["depth_rmse"]))
            est.append(sys.state.Tcw)
            gt.append(Tcw_gt)
        if sys.status == system_mod.LOST:
            break
    return sys, rmses, (est, gt)


@pytest.mark.slow
def test_fisheye_sequence_tracks():
    sys, rmses, _ = run_fisheye(deform_amp=0.0, n_frames=24)
    assert sys.status == system_mod.TRACKING, sys.status
    assert len(rmses) >= 8, len(rmses)
    # Measured median ~0.06 on this clip (CPU); gate just above it so a
    # 1.5x accuracy regression trips.
    assert np.median(rmses) < 0.1, rmses


@pytest.mark.slow
def test_fisheye_deforming_with_masker_tracks():
    """KB8 + deformation + masker: the Endomapper configuration end to end.
    The BorderFilter (border_filter.cc:24-38) crops detection/tracking to
    the interior, exercising mask-aware extraction under the fisheye +
    joint-solver interaction."""
    masker = masking.Masker([("BorderFilter", 6, 8)])
    sys, rmses, _ = run_fisheye(deform_amp=0.03, n_frames=36, masker=masker)
    assert sys.status == system_mod.TRACKING, sys.status
    assert len(rmses) >= 10, len(rmses)
    assert np.median(rmses) < 0.2, rmses
