import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras, se3
from nrslam.solver import pose_only


CAM = cameras.pinhole(472.65, 472.65, 479.5, 359.5)


def make_scene(n=200, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    X = jnp.stack([
        jax.random.uniform(k1, (n,), minval=-1.5, maxval=1.5),
        jax.random.uniform(k2, (n,), minval=-1.0, maxval=1.0),
        jax.random.uniform(k3, (n,), minval=2.0, maxval=6.0),
    ], axis=-1)
    Tcw_true = se3.exp(jnp.array([0.03, -0.02, 0.01, 0.1, -0.05, 0.08]))
    obs = cameras.project(CAM, se3.apply(Tcw_true, X))
    return X, obs, Tcw_true


def test_recovers_pose_from_clean_observations():
    X, obs, T_true = make_scene()
    T0 = se3.identity()
    T = pose_only.camera_pose_optimization(CAM, T0, X, obs, jnp.ones(X.shape[0], bool))
    err = se3.log(se3.compose(T, se3.inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 1e-3


def test_robust_to_outliers():
    X, obs, T_true = make_scene(seed=1)
    # corrupt 20% of observations badly
    n = X.shape[0]
    n_out = n // 5
    obs = obs.at[:n_out].add(80.0 * jax.random.normal(jax.random.PRNGKey(7), (n_out, 2)))
    T = pose_only.camera_pose_optimization(
        CAM, se3.identity(), X, obs, jnp.ones(n, bool))
    err = se3.log(se3.compose(T, se3.inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 5e-3, np.asarray(err)


def test_masked_slots_ignored():
    X, obs, T_true = make_scene(seed=2)
    n = X.shape[0]
    # garbage in masked-out slots must not affect the solution
    obs = obs.at[n // 2:].set(jnp.nan)
    valid = jnp.arange(n) < n // 2
    X = jnp.where(valid[:, None], X, 1.0)
    obs = jnp.where(valid[:, None], obs, 0.0)
    T = pose_only.camera_pose_optimization(CAM, se3.identity(), X, obs, valid)
    err = se3.log(se3.compose(T, se3.inverse(T_true)))
    assert float(jnp.linalg.norm(err)) < 1e-3


def test_jit_compiles():
    X, obs, _ = make_scene(seed=3)
    f = jax.jit(lambda t0: pose_only.camera_pose_optimization(
        CAM, t0, X, obs, jnp.ones(X.shape[0], bool)))
    T = f(se3.identity())
    assert np.isfinite(np.asarray(T.t)).all()
