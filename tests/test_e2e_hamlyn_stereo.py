"""Hamlyn stereo disk e2e: the last never-executed loader path.

Exports a synthetic stereo dataset in the Hamlyn cache layout
(images/ + images_right/ + settings.yaml with Stereo.bf) and drives
``apps/run_slam.py --dataset hamlyn`` over it as a subprocess: Settings ->
Hamlyn loader -> left-stream tracking -> stereo-GT evaluation
(TrackImageWithStereo, system.cc:134-160, with the reference's 1.5*IQR +
0.9-inlier alignment) -> stereo-RMSE file. The same fixture exercises the
Endomapper names.txt cache convention, the video-split path
(hamlyn.cc:100-149) and the transcribed rectification maps
(hamlyn.cc:152-249).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _export(tmp_path, n_frames=36):
    from nrslam.datasets import synthetic
    from nrslam.datasets.hamlyn_export import (
        export_hamlyn_stereo_dataset)
    scene = synthetic.SceneConfig(deform_amp=0.02)
    return export_hamlyn_stereo_dataset(tmp_path / "hamlyn", scene,
                                        n_frames=n_frames), scene


@pytest.mark.slow
def test_run_slam_hamlyn_stereo_from_disk(tmp_path):
    root, scene = _export(tmp_path)
    assert (root / "images" / "000000.png").exists()
    assert (root / "images_right" / "000000.png").exists()
    assert (root / "settings.yaml").exists()

    rmse_file = tmp_path / "stereo_rmse.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "apps" / "run_slam.py"),
         "--dataset", "hamlyn",
         "--dataset_path", str(root),
         "--settings_path", str(root / "settings.yaml"),
         "--end_frame", "36",
         "--save_rmse", str(rmse_file)],
        capture_output=True, text=True, env=env, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["status"] == "TRACKING", summary
    assert summary["frames_tracked"] >= 10, summary
    # Stereo-GT depth RMSE: NCC matches on the synthetic texture are noisy
    # relative to precomputed depth, and the monocular map is scale-aligned
    # during evaluation; measured median ~0.1 (CPU) at scene depth ~3.
    assert summary["median_stereo_rmse"] is not None, summary
    assert summary["median_stereo_rmse"] < 0.5, summary
    lines = rmse_file.read_text().strip().splitlines()
    assert len(lines) >= 10
    assert np.isfinite([float(x) for x in lines]).all()


def test_endomapper_names_txt_reads_same_cache(tmp_path):
    """The exported cache doubles as an Endomapper dataset via names.txt
    (endomapper.cc's split-once convention)."""
    root, scene = _export(tmp_path, n_frames=4)
    from nrslam.datasets.loaders import Endomapper
    ds = Endomapper(str(root))
    assert len(ds) == 4
    img = ds.get_image(2)
    assert img.shape[0] == scene.height and img.shape[1] == scene.width


def test_hamlyn_video_split_prepare(tmp_path):
    """Hamlyn.prepare splits a video into the PNG cache
    (hamlyn.cc:100-149)."""
    cv2 = pytest.importorskip("cv2")
    root, scene = _export(tmp_path, n_frames=6)
    video = tmp_path / "seq.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (scene.width, scene.height))
    if not vw.isOpened():
        pytest.skip("no video codec in this OpenCV build")
    for i in range(6):
        frame = cv2.imread(str(root / "images" / f"{i:06d}.png"))
        vw.write(frame)
    vw.release()

    from nrslam.datasets.loaders import Hamlyn
    out = tmp_path / "split" / "images"
    n = Hamlyn.prepare(str(video), str(out))
    assert n == 6
    ds = Hamlyn(str(tmp_path / "split"))
    assert len(ds) == 6
    img = ds.get_image(0)
    assert img.shape == (scene.height, scene.width)


def test_rectification_maps_on_exported_pair(tmp_path):
    """Drive the transcribed stereoRectify/initUndistortRectifyMap path
    (hamlyn.cc:152-249) over an exported pair: an ideal rig (zero
    distortion, pure x-baseline) must come out with the baseline preserved
    in the rectified projections (bf = -P2[0,3] = fx_rect * baseline)."""
    cv2 = pytest.importorskip("cv2")
    root, scene = _export(tmp_path, n_frames=1)
    from nrslam.datasets import rectification as rect

    b = 0.12
    K = np.array([[scene.fx, 0.0, (scene.width - 1) / 2.0],
                  [0.0, scene.fy, (scene.height - 1) / 2.0],
                  [0.0, 0.0, 1.0]])
    calib = rect.StereoCalibration(
        K_left=K, D_left=np.zeros(4), K_right=K, D_right=np.zeros(4),
        R=np.eye(3), T=np.array([-b, 0.0, 0.0]),
        image_size=(scene.width, scene.height))

    left = cv2.imread(str(root / "images" / "000000.png"),
                      cv2.IMREAD_GRAYSCALE)
    right = cv2.imread(str(root / "images_right" / "000000.png"),
                       cv2.IMREAD_GRAYSCALE)
    left_r, right_r, fx, bf = rect.rectify_pair(calib, left, right)
    assert left_r.shape == right_r.shape
    assert left_r.std() > 10.0 and right_r.std() > 10.0  # real content
    # Baseline survives rectification exactly.
    assert abs(bf / fx - b) < 1e-4, (fx, bf)
    # The reference's transcribed Hamlyn calibrations build maps too.
    map_l, map_r, P1, P2 = rect.rectify_maps(rect.HAMLYN_20_21)
    assert map_l[0].shape == map_r[0].shape
    assert abs(-P2[0, 3] / P2[0, 0]
               - np.linalg.norm(rect.HAMLYN_20_21.T)) < 0.35
