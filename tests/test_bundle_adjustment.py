import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras, se3
from nrslam.solver import bundle_adjustment as ba
from nrslam.solver import pose_deformation as pd


CAM = cameras.pinhole(472.65, 472.65, 479.5, 359.5)


def knn_pairs(X, k=8):
    d = np.linalg.norm(np.asarray(X)[:, None] - np.asarray(X)[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=-1)[:, :k].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=-1).astype(np.float32)
    sigma = np.median(dist) * 3
    w = np.exp(-(dist ** 2) / (2 * sigma ** 2)).astype(np.float32)
    return pd.pairs_from_neighbors(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(dist),
        jnp.ones_like(jnp.asarray(w), bool))


def make_window(K=5, P=120, deform_amp=0.02, seed=0):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 3)
    X = jnp.stack([
        jax.random.uniform(ks[0], (P,), minval=-1.2, maxval=1.2),
        jax.random.uniform(ks[1], (P,), minval=-0.9, maxval=0.9),
        jax.random.uniform(ks[2], (P,), minval=2.5, maxval=3.8),
    ], -1)

    poses, L_true, obs = [], [], []
    for k in range(K):
        tw = jnp.array([0.01 * k, -0.005 * k, 0.008 * k, 0.06 * k, 0.0, 0.02 * k])
        T = se3.exp(tw)
        d = deform_amp * jnp.stack([
            jnp.sin(X[:, 0] * 2 + k), jnp.cos(X[:, 1] + 0.5 * k),
            jnp.sin(X[:, 0] + X[:, 1] + k)], -1)
        Lk = X + d
        poses.append(T)
        L_true.append(Lk)
        obs.append(cameras.project(CAM, se3.apply(T, Lk)))
    poses = se3.stack(poses)
    L_true = jnp.stack(L_true)
    obs = jnp.stack(obs)

    # rest distances from the first keyframe geometry
    pairs = knn_pairs(L_true[0])
    d0 = jnp.linalg.norm(L_true[0][pairs.i] - L_true[0][pairs.j], axis=-1)
    pairs = pairs._replace(d0=d0)

    problem = ba.BAProblem(
        obs=obs,
        obs_valid=jnp.ones((K, P), bool),
        kf_valid=jnp.ones(K, bool),
        pairs=pairs,
        scale=jnp.float32(1.0),
    )
    return poses, L_true, obs, problem


def test_ba_reduces_noise():
    poses_true, L_true, obs, problem = make_window()
    key = jax.random.PRNGKey(42)
    # noisy seeds: poses + landmarks perturbed
    noise_t = 0.01 * jax.random.normal(key, poses_true.t.shape)
    poses0 = se3.SE3(poses_true.q, poses_true.t + noise_t)
    L0 = L_true + 0.03 * jax.random.normal(jax.random.fold_in(key, 1), L_true.shape)

    poses1, L1 = ba.local_deformable_ba(CAM, poses0, L0, problem)

    def reproj_rmse(poses, L):
        pred = cameras.project(CAM, se3.apply(
            jax.tree.map(lambda x: x[:, None], poses), L))
        return float(jnp.sqrt(jnp.mean(jnp.sum((pred - obs) ** 2, -1))))

    before = reproj_rmse(poses0, L0)
    after = reproj_rmse(poses1, L1)
    assert after < 0.2 * before, (before, after)

    # 3D error should also drop (up to gauge): compare in first-KF frame
    err0 = float(jnp.median(jnp.linalg.norm(L0 - L_true, axis=-1)))
    err1 = float(jnp.median(jnp.linalg.norm(L1 - L_true, axis=-1)))
    assert err1 < err0, (err0, err1)


def test_ba_clean_solution_stays_consistent():
    poses_true, L_true, obs, problem = make_window(seed=5, deform_amp=0.02)
    poses1, L1 = ba.local_deformable_ba(CAM, poses_true, L_true, problem)
    # The springs intentionally tug the deformed geometry toward its rest
    # distances (visco-elastic prior), so positions move on the order of the
    # deformation amplitude — but reprojection must stay consistent and the
    # motion bounded.
    pred = cameras.project(CAM, se3.apply(
        jax.tree.map(lambda x: x[:, None], poses1), L1))
    rmse = float(jnp.sqrt(jnp.mean(jnp.sum((pred - obs) ** 2, -1))))
    assert rmse < 0.5, rmse
    move = float(jnp.median(jnp.linalg.norm(L1 - L_true, axis=-1)))
    assert move < 2 * 0.02, move


def test_ba_masked_keyframes_ignored():
    poses_true, L_true, obs, problem = make_window(K=5)
    kf_valid = jnp.array([True, True, True, False, False])
    problem = problem._replace(
        kf_valid=kf_valid,
        obs=jnp.where(kf_valid[:, None, None], problem.obs, jnp.nan))
    L0 = jnp.where(kf_valid[:, None, None], L_true, 1.0)
    poses1, L1 = ba.local_deformable_ba(CAM, poses_true, L0, problem)
    assert np.isfinite(np.asarray(L1[:3])).all()
    assert np.isfinite(np.asarray(poses1.t[:3])).all()
