import os

import jax
import jax.numpy as jnp
import numpy as np

from nrslam.config import Settings
from nrslam.eval import metrics
from nrslam.geometry import se3
from nrslam.slam import state as state_mod
from nrslam.slam.state import Config
from nrslam.utils import checkpoint
from nrslam.utils.profiler import TimeProfiler


def test_settings_parses_reference_yaml(tmp_path):
    yaml = """%YAML:1.0
Camera.model: "PinHole"
Camera.fx: 472.64955100886374
Camera.fy: 472.64955100886374
Camera.cx: 479.5
Camera.cy: 359.5
Camera.radiansPerPixel: 0.002
System.autoplay: 1
Evaluation.save_path: ""
MapVisualizer.left_view: !!opencv-matrix
  rows: 4
  cols: 4
"""
    p = tmp_path / "settings.yaml"
    p.write_text(yaml)
    s = Settings(str(p))
    assert s.calibration.kind == "pinhole"
    np.testing.assert_allclose(float(s.calibration.fx), 472.6495, rtol=1e-5)
    assert s.rad_per_pixel == 0.002
    cfg = s.slam_config(max_points=128)
    assert cfg.max_points == 128 and cfg.rad_per_pixel == 0.002


def test_settings_kb8(tmp_path):
    yaml = """%YAML:1.0
Camera.model: "KannalaBrandt8"
Camera.fx: 383.0
Camera.fy: 383.5
Camera.cx: 478.3
Camera.cy: 269.2
Camera.k0: -0.006
Camera.k1: 0.043
Camera.k2: -0.035
Camera.k3: 0.005
"""
    p = tmp_path / "settings.yaml"
    p.write_text(yaml)
    s = Settings(str(p))
    assert s.calibration.kind == "kb8"


def test_checkpoint_roundtrip(tmp_path):
    config = Config(max_points=32, max_keyframes=3, temporal_window=4,
                    klt_levels=2, klt_win=5)
    state = state_mod.empty_state(config, (32, 32))
    state = state._replace(scale=jnp.float32(2.5),
                           positions=state.positions.at[0].set(jnp.array([1., 2., 3.])))
    checkpoint.save(str(tmp_path / "ck"), state)
    state2 = checkpoint.restore(str(tmp_path / "ck"), state)
    np.testing.assert_allclose(np.asarray(state2.positions[0]), [1, 2, 3])
    assert float(state2.scale) == 2.5


def test_ate_alignment_invariance():
    # A trajectory measured in a rotated/scaled frame has ~zero ATE.
    ts = np.linspace(0, 1, 20)
    gt = [se3.SE3(jnp.array([1.0, 0, 0, 0]),
                  jnp.array([t, np.sin(t), 0.1 * t], dtype=np.float32))
          for t in ts]
    Rz = se3.exp(jnp.array([0.0, 0.0, 0.7, 0.3, -0.2, 0.5]))
    est = [se3.compose(g, Rz) for g in gt]  # Tcw' = Tcw * Rz => centers rotated
    assert metrics.ate_rmse(est, gt) < 1e-4


def test_ate_detects_error():
    ts = np.linspace(0, 1, 20)
    gt = [se3.SE3(jnp.array([1.0, 0, 0, 0]),
                  jnp.array([t, 0, 0], dtype=np.float32)) for t in ts]
    est = [se3.SE3(g.q, g.t + 0.1 * np.random.RandomState(i).randn(3).astype(np.float32))
           for i, g in enumerate(gt)]
    assert metrics.ate_rmse(est, gt) > 0.02


def test_profiler():
    p = TimeProfiler()
    with p.section("x"):
        pass
    st = p.statistics()
    assert "x" in st and st["x"]["count"] == 1


def test_viz_dumps(tmp_path):
    from nrslam.viz import dumps
    config = Config(max_points=16, max_keyframes=2, temporal_window=3,
                    klt_levels=2, klt_win=5)
    state = state_mod.empty_state(config, (24, 32))
    state = state._replace(
        slot_used=jnp.ones(16, bool), has_3d=jnp.ones(16, bool),
        positions=jax.random.normal(jax.random.PRNGKey(0), (16, 3)),
        keypoints=5.0 + 10 * jax.random.uniform(jax.random.PRNGKey(1), (16, 2)),
        status=jnp.zeros(16, jnp.int32))
    state = state_mod.insert_keyframe(state)
    img = dumps.draw_frame(np.zeros((24, 32)), state.keypoints, state.status,
                           state.slot_used)
    assert img.shape == (24, 32, 3) and img.max() > 0
    dumps.export_ply(str(tmp_path / "map.ply"), state)
    txt = (tmp_path / "map.ply").read_text()
    assert "element vertex 17" in txt  # 16 landmarks + 1 keyframe


def test_viz_flow_trails(tmp_path):
    """Flow-trail overlays + 3D trail export (DrawOpticalFlow,
    image_visualizer.cc:117-150; GetLandmarkFlow(20) -> Draw3DFlow,
    map_visualizer.cc:166-199)."""
    from nrslam.viz import dumps
    config = Config(max_points=8, max_keyframes=2, temporal_window=4,
                    klt_levels=2, klt_win=5)
    state = state_mod.empty_state(config, (24, 32))
    state = state._replace(
        slot_used=jnp.ones(8, bool), has_3d=jnp.ones(8, bool),
        positions=jnp.ones((8, 3)),
        keypoints=5.0 + 10 * jax.random.uniform(jax.random.PRNGKey(1), (8, 2)),
        status=jnp.zeros(8, jnp.int32))
    # Three snapshots with drifting keypoints/positions.
    for k in range(3):
        state = state_mod.insert_temporal_snapshot(state)
        state = state._replace(keypoints=state.keypoints + 2.0,
                               positions=state.positions + 0.1)
    img = dumps.draw_optical_flow(np.zeros((24, 32)), state)
    assert img.shape == (24, 32, 3) and img.max() > 0

    dumps.export_flow_trails_ply(str(tmp_path / "trails.ply"), state)
    txt = (tmp_path / "trails.ply").read_text()
    # 8 landmarks x 3 buffered snapshots, 2 segments per trail.
    assert "element vertex 24" in txt
    assert "element edge 16" in txt


def test_viz_cluster_and_inlier_overlays():
    from nrslam.viz import dumps
    n = 40
    key = jax.random.PRNGKey(0)
    ref = 5.0 + 20.0 * jax.random.uniform(key, (n, 2))
    # Two distinct flow clusters.
    flow = jnp.where((jnp.arange(n) < 20)[:, None],
                     jnp.array([3.0, 0.0]), jnp.array([-3.0, 2.0]))
    cur = ref + flow
    valid = jnp.ones(n, bool).at[-3:].set(False)
    labels = dumps.cluster_flow_tracks(ref, cur, valid)
    assert labels[~np.asarray(valid)].max() == -1
    assert len(set(labels[np.asarray(valid)].tolist())) >= 2
    img = dumps.draw_clustered_flow(np.zeros((32, 32)), ref, cur, valid,
                                    labels)
    assert img.max() > 0
    inl = jnp.arange(n) % 2 == 0
    img2 = dumps.draw_essential_inliers(np.zeros((32, 32)), cur, inl, valid)
    assert img2.max() > 0
