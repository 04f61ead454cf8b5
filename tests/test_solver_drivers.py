"""Solver-driver scenarios at the shapes the frame program feeds them.

Pinhole and KB8 cameras, odd and non-square point counts, masked points and
edges, a tiny map's edge budget, chi2 re-leveling with gross outliers,
masked keyframes and partial observations in BA. Each result is checked
against ground truth or against a float64 NumPy reprojection residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.geometry import cameras, se3
from nrslam.solver import bundle_adjustment as ba
from nrslam.solver import pose_deformation as pd
from nrslam.solver import pose_only

from test_bundle_adjustment import CAM as BA_CAM
from test_bundle_adjustment import make_window
from test_pose_deformation import knn_table, make_scene

CAM_PIN = cameras.pinhole(472.65, 472.65, 479.5, 359.5)
CAM_KB8 = cameras.kannala_brandt8(400.0, 400.0, 479.5, 359.5,
                                  0.05, -0.01, 0.004, -0.001)
CAMS = pytest.mark.parametrize("cam", [CAM_PIN, CAM_KB8],
                               ids=["pinhole", "kb8"])


def project64(cam, T, X):
    """float64 NumPy projection of world points X [..., 3] through Tcw."""
    q = np.asarray(T.q, np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    Xc = np.asarray(X, np.float64) @ R.T + np.asarray(T.t, np.float64)
    p = np.asarray(cam.params, np.float64)
    if cam.kind == cameras.PINHOLE:
        return np.stack([p[0] * Xc[..., 0] / Xc[..., 2] + p[2],
                         p[1] * Xc[..., 1] / Xc[..., 2] + p[3]], -1)
    rho = np.hypot(Xc[..., 0], Xc[..., 1])
    theta = np.arctan2(rho, Xc[..., 2])
    psi = np.arctan2(Xc[..., 1], Xc[..., 0])
    t2 = theta * theta
    r = theta * (1 + t2 * (p[4] + t2 * (p[5] + t2 * (p[6] + t2 * p[7]))))
    return np.stack([p[0] * r * np.cos(psi) + p[2],
                     p[1] * r * np.sin(psi) + p[3]], -1)


def pose_error(T, T_true):
    return float(jnp.linalg.norm(se3.log(se3.compose(T, se3.inverse(T_true)))))


# --- pose-only LM -----------------------------------------------------------

def _pose_problem(cam, n, key):
    X = jax.random.uniform(key, (n, 3), minval=-1, maxval=1) \
        + jnp.array([0.0, 0.0, 3.0])
    T_true = se3.SE3(se3.quat_normalize(jnp.array([1.0, 0.02, -0.03, 0.01])),
                     jnp.array([0.05, -0.02, 0.1]))
    obs = cameras.project(cam, se3.apply(T_true, X))
    obs = obs + 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (n, 2))
    outlier = jax.random.uniform(jax.random.fold_in(key, 2), (n,)) < 0.1
    obs = jnp.where(outlier[:, None], obs + 20.0, obs)
    valid = jnp.arange(n) % 7 != 3
    return X, obs, valid, outlier, T_true


@pytest.mark.parametrize("cam,n", [(CAM_PIN, 200), (CAM_KB8, 200),
                                   (CAM_PIN, 131)],
                         ids=["pinhole", "kb8", "pinhole-odd-P"])
def test_pose_only_noisy_outliers_and_masks(cam, n):
    """0.3 px noise, 10% gross outliers and masked slots: the pose lands on
    the truth, and the float64 residual of the inliers is the noise."""
    X, obs, valid, outlier, T_true = _pose_problem(cam, n,
                                                   jax.random.PRNGKey(n))
    T = pose_only.camera_pose_optimization(cam, se3.identity(), X, obs, valid)
    assert float(jnp.linalg.norm(T.t - T_true.t)) < 0.01
    inl = np.asarray(valid & ~outlier)
    res = np.linalg.norm(project64(cam, T, X) - np.asarray(obs), axis=-1)
    assert np.sqrt(np.mean(res[inl] ** 2)) < 0.6, res[inl]


# --- joint pose + deformation LM ---------------------------------------------

def _joint_problem(cam, n=150, seed=0, deform_amp=0.05, n_outliers=0,
                   masked_points=0, k=10, knock_out_edges=True):
    X, flow_true, T_true, _ = make_scene(n=n, seed=seed,
                                         deform_amp=deform_amp)
    obs = cameras.project(cam, se3.apply(T_true, X + flow_true))
    if n_outliers:
        obs = obs.at[:n_outliers].add(
            40.0 * jax.random.normal(jax.random.PRNGKey(seed + 7),
                                     (n_outliers, 2)))
    valid = jnp.ones(n, bool)
    if masked_points:
        valid = valid.at[-masked_points:].set(False)
    T_seed = pose_only.camera_pose_optimization(cam, se3.identity(), X, obs,
                                                valid)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = knn_table(X, k=k)
    if knock_out_edges:
        nbr_valid = nbr_valid.at[10:20, ::2].set(False)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0, nbr_valid)
    res = pd.pose_deformation_optimization(cam, T_seed, X, obs, valid, pairs,
                                           scale=1.0)
    return X, flow_true, T_true, obs, valid, res


def _assert_explains_observations(cam, X, obs, valid, res, outliers=0):
    """float64 residual of the inliers at the optimum is sub-pixel."""
    ok = np.array(res.reproj_inlier & valid)
    ok[:outliers] = False
    assert ok.sum() > 0.8 * (np.asarray(valid).sum() - outliers)
    pred = project64(cam, res.Tcw, np.asarray(X) + np.asarray(res.flows))
    err = np.linalg.norm(pred - np.asarray(obs), axis=-1)[ok]
    assert np.median(err) < 0.5, np.median(err)


@CAMS
def test_joint_lm_with_outliers_and_masked_edges(cam):
    X, _, T_true, obs, valid, res = _joint_problem(cam, n_outliers=8)
    _assert_explains_observations(cam, X, obs, valid, res, outliers=8)
    assert pose_error(res.Tcw, T_true) < 0.15


def test_joint_lm_masked_points_keep_zero_flow():
    X, _, T_true, obs, valid, res = _joint_problem(
        CAM_PIN, deform_amp=0.03, n_outliers=5, masked_points=23)
    assert float(jnp.max(jnp.abs(res.flows[-23:]))) == 0.0
    assert not np.asarray(res.reproj_inlier[-23:]).any()
    _assert_explains_observations(CAM_PIN, X, obs, valid, res, outliers=5)


def test_joint_lm_odd_point_count():
    X, _, T_true, obs, valid, res = _joint_problem(CAM_PIN, n=131,
                                                   deform_amp=0.04)
    _assert_explains_observations(CAM_PIN, X, obs, valid, res)
    assert pose_error(res.Tcw, T_true) < 0.15


def test_joint_lm_tiny_map_edge_budget():
    """P=40 with K=6 neighbours: the raw edge table is smaller than the
    rounded-up compaction budget, so compaction must leave it whole."""
    X, _, T_true, obs, valid, res = _joint_problem(
        CAM_PIN, n=40, seed=5, deform_amp=0.02, k=6, knock_out_edges=False)
    nbr = knn_table(X, k=6)
    pairs = pd.pairs_from_neighbors(*nbr)
    assert pd.compact_pairs(pairs, 40).i.shape == pairs.i.shape
    _assert_explains_observations(CAM_PIN, X, obs, valid, res)


def test_joint_lm_relevel_converges_to_truth():
    """With 12 gross outliers the second round runs on re-leveled masks and
    lands near the rigid truth; each outlier fails at least one gate."""
    X, _, T_true, obs, valid, res = _joint_problem(
        CAM_PIN, deform_amp=0.0, n_outliers=12, seed=2)
    # Rigid truth up to the nonrigid gauge (a common flow translation trades
    # against camera translation).
    assert pose_error(res.Tcw, T_true) < 0.05
    assert float(jnp.median(jnp.linalg.norm(res.flows, axis=-1))) < 0.05
    demoted = ~(np.asarray(res.reproj_inlier) & np.asarray(res.deform_ok))[:12]
    assert demoted.mean() > 0.5, demoted


# --- keyframe BA --------------------------------------------------------------

def _noisy_seeds(poses_true, L_true, seed=42):
    key = jax.random.PRNGKey(seed)
    poses0 = se3.SE3(poses_true.q, poses_true.t + 0.01 * jax.random.normal(
        key, poses_true.t.shape))
    L0 = L_true + 0.03 * jax.random.normal(jax.random.fold_in(key, 1),
                                           L_true.shape)
    return poses0, L0


def _ba_rmse64(poses, L, obs, mask):
    err = np.stack([np.linalg.norm(
        project64(BA_CAM, jax.tree.map(lambda x: x[k], poses), L[k])
        - np.asarray(obs[k]), axis=-1) for k in range(L.shape[0])])
    return float(np.sqrt(np.mean(err[np.asarray(mask)] ** 2)))


def test_ba_masked_keyframes_pass_through():
    """Invalid keyframe slots (NaN observations) must not poison the solve,
    and their landmark copies keep their input values exactly."""
    poses_true, L_true, obs, problem = make_window(K=5, P=96)
    kf_valid = jnp.array([True, True, True, False, False])
    problem = problem._replace(
        kf_valid=kf_valid,
        obs=jnp.where(kf_valid[:, None, None], problem.obs, jnp.nan))
    poses0, L0 = _noisy_seeds(poses_true, L_true)
    L0 = jnp.where(kf_valid[:, None, None], L0, 1.0)
    poses1, L1 = ba.local_deformable_ba(BA_CAM, poses0, L0, problem,
                                        cg_iters=16)
    np.testing.assert_array_equal(np.asarray(L1[3:]), np.asarray(L0[3:]))
    mask = jnp.broadcast_to(kf_valid[:, None], problem.obs_valid.shape)
    before = _ba_rmse64(poses0, L0, obs, mask)
    after = _ba_rmse64(poses1, L1, obs, mask)
    assert after < 0.2 * before, (before, after)


def test_ba_partial_observations():
    """Per-keyframe observation masks (each keyframe sees only its tracked
    subset): the observed reprojection error collapses and the landmarks
    move toward the truth."""
    poses_true, L_true, obs, problem = make_window(K=4, P=96, seed=3)
    obs_valid = jax.random.uniform(jax.random.PRNGKey(7),
                                   problem.obs_valid.shape) > 0.25
    problem = problem._replace(obs_valid=obs_valid)
    poses0, L0 = _noisy_seeds(poses_true, L_true)
    poses1, L1 = ba.local_deformable_ba(BA_CAM, poses0, L0, problem,
                                        cg_iters=16)
    before = _ba_rmse64(poses0, L0, obs, obs_valid)
    after = _ba_rmse64(poses1, L1, obs, obs_valid)
    assert after < 0.2 * before, (before, after)
    err0 = float(jnp.median(jnp.linalg.norm(L0 - L_true, axis=-1)))
    err1 = float(jnp.median(jnp.linalg.norm(L1 - L_true, axis=-1)))
    assert err1 < err0, (err0, err1)
