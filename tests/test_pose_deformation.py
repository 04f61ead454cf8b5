import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras, se3
from nrslam.solver import pose_deformation as pd


CAM = cameras.pinhole(472.65, 472.65, 479.5, 359.5)


def knn_table(X, k=10):
    """Neighbor table [P, k] by 3D distance with RBF weights (sigma from spread)."""
    d = np.linalg.norm(np.asarray(X)[:, None] - np.asarray(X)[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=-1)[:, :k].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=-1)
    sigma = np.median(dist) * 3
    w = np.exp(-(dist ** 2) / (2 * sigma ** 2)).astype(np.float32)
    valid = np.ones_like(w, bool)
    return (jnp.asarray(idx), jnp.asarray(w), jnp.asarray(dist, jnp.float32),
            jnp.asarray(valid))


def make_scene(n=150, seed=0, deform_amp=0.0):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 4)
    X = jnp.stack([
        jax.random.uniform(ks[0], (n,), minval=-1.2, maxval=1.2),
        jax.random.uniform(ks[1], (n,), minval=-0.9, maxval=0.9),
        jax.random.uniform(ks[2], (n,), minval=2.5, maxval=4.0),
    ], axis=-1)
    # smooth deformation field: sinusoidal over x
    flow_true = deform_amp * jnp.stack([
        jnp.sin(2.0 * X[:, 0]), jnp.cos(1.5 * X[:, 1]), jnp.sin(X[:, 0] + X[:, 1]),
    ], axis=-1)
    T_true = se3.exp(jnp.array([0.02, -0.01, 0.015, 0.06, -0.04, 0.05]))
    obs = cameras.project(CAM, se3.apply(T_true, X + flow_true))
    return X, flow_true, T_true, obs


def run(X, obs, rounds=(10, 10)):
    """Mirror the pipeline: pose-only first, then joint pose+deformation
    (tracking.cc:291-330 calls CameraPoseEstimation before
    CameraPoseAndDeformationEstimation; the joint problem has a
    translation gauge freedom that the pose-only seed anchors)."""
    from nrslam.solver import pose_only
    valid = jnp.ones(X.shape[0], bool)
    T_seed = pose_only.camera_pose_optimization(CAM, se3.identity(), X, obs, valid)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = knn_table(X)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0, nbr_valid)
    return pd.pose_deformation_optimization(
        CAM, T_seed, X, obs, valid, pairs, scale=1.0, rounds=rounds)


def test_rigid_scene_recovers_pose_with_tiny_flows():
    X, _, T_true, obs = make_scene(deform_amp=0.0)
    res = run(X, obs)
    err = se3.log(se3.compose(res.Tcw, se3.inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 5e-3, np.asarray(err)
    assert float(jnp.median(jnp.linalg.norm(res.flows, axis=-1))) < 5e-3
    assert np.asarray(res.reproj_inlier).mean() > 0.9


def test_deforming_scene_recovers_flows():
    X, flow_true, T_true, obs = make_scene(deform_amp=0.05)
    res = run(X, obs)
    # Pose is only defined up to the nonrigid gauge (a common flow translation
    # trades against camera translation); it should still stay in the
    # neighborhood of the true pose.
    err = se3.log(se3.compose(res.Tcw, se3.inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 0.15, np.asarray(err)
    ok = np.asarray(res.reproj_inlier)
    assert ok.mean() > 0.8
    # The optimized state must explain the observations (deformation absorbs
    # the image motion the rigid model cannot).
    reproj = cameras.project(CAM, se3.apply(res.Tcw, X + res.flows))
    px_err = np.linalg.norm(np.asarray(reproj - obs), axis=-1)[ok]
    assert np.median(px_err) < 0.5, np.median(px_err)
    rigid_reproj = cameras.project(CAM, se3.apply(res.Tcw, X))
    rigid_err = np.linalg.norm(np.asarray(rigid_reproj - obs), axis=-1)[ok]
    assert np.median(px_err) < 0.2 * np.median(rigid_err)
    # Recovered 3D positions should beat the rest positions (depth-axis
    # deformation is weakly observable, so expect improvement, not identity).
    pos_err = np.linalg.norm(np.asarray(res.flows - flow_true), axis=-1)[ok]
    base_err = np.linalg.norm(np.asarray(flow_true), axis=-1)[ok]
    assert np.median(pos_err) < 0.8 * np.median(base_err), (
        np.median(pos_err), np.median(base_err))


def test_pairs_dedup():
    nbr_idx = jnp.array([[1, 2], [0, 2], [0, 1]], jnp.int32)
    nbr_w = jnp.ones((3, 2))
    nbr_d0 = jnp.ones((3, 2))
    nbr_valid = jnp.ones((3, 2), bool)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0, nbr_valid)
    # fully mutual 3-clique -> exactly 3 unique undirected pairs
    assert int(jnp.sum(pairs.valid)) == 3
    kept = set()
    for i, j, v in zip(np.asarray(pairs.i), np.asarray(pairs.j), np.asarray(pairs.valid)):
        if v:
            kept.add((min(i, j), max(i, j)))
    assert kept == {(0, 1), (0, 2), (1, 2)}


def test_lost_point_drag_is_robust_mean():
    flows = jnp.array([[0.1, 0.0, 0.0], [0.12, 0.0, 0.0], [5.0, 5.0, 5.0]])
    lost_idx = jnp.array([[0, 1, 2]], jnp.int32)
    w = jnp.ones((1, 3))
    valid = jnp.ones((1, 3), bool)
    f = pd.lost_point_drag(flows, lost_idx, w, valid, scale=1.0)
    # outlier neighbor down-weighted by huber
    assert abs(float(f[0, 0]) - 0.11) < 0.15
    assert float(f[0, 1]) < 1.0


def test_outlier_observation_demoted():
    X, _, T_true, obs = make_scene(seed=3, deform_amp=0.0)
    obs = obs.at[0].add(jnp.array([150.0, -90.0]))
    res = run(X, obs)
    # A wild observation is either rejected by reprojection chi2 or absorbed
    # into an implausibly large flow that the IQR gate then rejects — the
    # reference demotes the point in both cases (g2o_optimization.cc:424-437).
    assert (not bool(res.reproj_inlier[0])) or (not bool(res.deform_ok[0]))
    # The rest of the points must be unaffected.
    assert np.asarray(res.reproj_inlier)[1:].mean() > 0.95
