"""Disk-dataset integration test: the full TrackImageWithDepth path.

Exports the synthetic scene to a Simulation-layout directory (rgb PNGs,
depth images, trajectory.csv, settings.yaml, filters.txt — the exact
convention of modules/datasets/simulation.cc:77-137) and drives
``apps/run_slam.py --dataset simulation`` over it as a subprocess. This
exercises, end to end and from disk: config.Settings (the OpenCV-YAML
dialect + filters.txt masker, settings.cc:82-174), the Simulation loader
with depth linearization, preprocessing + masking, the whole SLAM pipeline,
and the depth-RMSE evaluator — the closest achievable stand-in for a
real-data parity run in a zero-egress image.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_run_slam_simulation_from_disk(tmp_path):
    from nrslam.datasets import synthetic
    from nrslam.datasets.simulation_export import (
        export_simulation_dataset)

    scene = synthetic.SceneConfig(deform_amp=0.02)
    n_frames = 30
    root = export_simulation_dataset(tmp_path / "sim", scene,
                                     n_frames=n_frames)

    # Layout sanity (the convention simulation.cc expects).
    assert (root / "rgb" / "image_0000.png").exists()
    assert sorted((root / "depth").glob("aov_image_*.*"))
    assert (root / "trajectory.csv").exists()
    assert (root / "settings.yaml").exists()
    assert (root / "filters.txt").exists()

    rmse_file = tmp_path / "rmse.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # single CPU device is fine for the CLI
    proc = subprocess.run(
        [sys.executable, str(REPO / "apps" / "run_slam.py"),
         "--dataset", "simulation",
         "--dataset_path", str(root),
         "--settings_path", str(root / "settings.yaml"),
         "--end_frame", str(n_frames),
         "--max_points", "256",
         "--save_rmse", str(rmse_file)],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])

    assert summary["status"] == "TRACKING", (summary, proc.stderr[-2000:])
    assert summary["frames_tracked"] >= 10, summary
    # Scene depth ~3 units; disk round trip (PNG16 depth fallback: ~6e-5
    # quantization) must not degrade the in-process e2e accuracy family.
    assert summary["median_rmse"] is not None
    assert summary["median_rmse"] < 0.15, summary
    assert summary["fps"] is not None and summary["fps"] > 0

    # The evaluator RMSE file (Evaluation.save_path behavior,
    # frame_evaluator.cc:281-289) must hold one value per tracked frame.
    vals = [float(v) for v in rmse_file.read_text().split()]
    assert len(vals) >= 10
    assert np.median(vals) == pytest.approx(summary["median_rmse"], rel=1e-6)


def test_simulation_loader_roundtrip(tmp_path):
    """Fast loader-only check: poses and depth survive the disk round trip."""
    from nrslam.datasets import synthetic
    from nrslam.datasets.loaders import Simulation
    from nrslam.datasets.simulation_export import (
        export_simulation_dataset)
    from nrslam.geometry import se3

    scene = synthetic.SceneConfig(height=60, width=80, deform_amp=0.0)
    root = export_simulation_dataset(tmp_path / "sim", scene, n_frames=3)
    ds = Simulation(str(root))
    assert len(ds) == 3

    for i in range(3):
        gray_ref, depth_ref, Tcw_ref = synthetic.render_frame(i, scene)
        img = ds.get_image(i)
        assert img.shape == (60, 80, 3)
        # 8-bit gray quantization only.
        assert np.max(np.abs(img[..., 0] - np.asarray(gray_ref))) <= 1.0
        depth = ds.get_depth_image(i)
        assert np.max(np.abs(depth - np.asarray(depth_ref))) < 2e-3
        Tcw = ds.get_camera_pose(i)
        err = se3.log(se3.compose(Tcw, se3.inverse(Tcw_ref)))
        assert float(np.linalg.norm(np.asarray(err))) < 1e-5
