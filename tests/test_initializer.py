import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras, se3
from nrslam.slam import initializer as ini


CAM = cameras.pinhole(400.0, 400.0, 320.0, 240.0)
CFG = ini.InitializerConfig(max_features=512, min_triangulated=80,
                            n_hypotheses=48)


def synthetic_correspondences(n=300, outlier_frac=0.1, seed=0):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 5)
    X = jnp.stack([
        jax.random.uniform(ks[0], (n,), minval=-1.2, maxval=1.2),
        jax.random.uniform(ks[1], (n,), minval=-0.9, maxval=0.9),
        jax.random.uniform(ks[2], (n,), minval=2.0, maxval=5.0),
    ], -1)
    T_true = se3.exp(jnp.array([0.02, -0.04, 0.01, 0.25, 0.05, -0.1]))
    ref_uv = cameras.project(CAM, X)
    cur_uv = cameras.project(CAM, se3.apply(T_true, X))
    n_out = int(n * outlier_frac)
    cur_uv = cur_uv.at[:n_out].add(
        40.0 * jax.random.normal(ks[3], (n_out, 2)))
    return X, T_true, ref_uv, cur_uv


def make_state(ref_uv, cur_uv, n_cap=512):
    n = ref_uv.shape[0]
    pad = n_cap - n
    z2 = jnp.zeros((pad, 2))
    valid = jnp.concatenate([jnp.ones(n, bool), jnp.zeros(pad, bool)])
    status = jnp.where(valid, ini.klt.TRACKED, ini.klt.BAD).astype(jnp.int32)
    return ini.InitializerState(
        ref_keypoints=jnp.concatenate([ref_uv, z2]),
        cur_keypoints=jnp.concatenate([cur_uv, z2]),
        track_id=jnp.arange(n_cap, dtype=jnp.int32),
        status=status,
        valid=valid,
        refs=None,
        frames_from_ref=jnp.int32(5),
        next_track_id=jnp.int32(n_cap),
    )


def test_essential_ransac_and_reconstruction():
    X, T_true, ref_uv, cur_uv = synthetic_correspondences()
    state = make_state(ref_uv, cur_uv)
    res = ini.try_initialize(CAM, state, CFG, jax.random.PRNGKey(0))
    assert bool(res.success)

    # Rotation recovered (translation only up to scale).
    R_est = se3.quat_to_matrix(res.Tcw.q)
    R_true = se3.quat_to_matrix(T_true.q)
    rot_err = np.arccos(np.clip((np.trace(np.asarray(R_est.T @ R_true)) - 1) / 2, -1, 1))
    assert rot_err < 0.01, rot_err

    t_est = np.asarray(res.Tcw.t)
    t_true = np.asarray(T_true.t)
    cos = abs(np.dot(t_est, t_true) / (np.linalg.norm(t_est) * np.linalg.norm(t_true)))
    assert cos > 0.99, cos

    # Triangulated points match GT up to the global scale.
    n = X.shape[0]
    ok = np.asarray(res.point_ok)[:n]
    assert ok.sum() >= 80
    lm = np.asarray(res.landmarks)[:n]
    scale = np.median(np.asarray(X)[ok, 2] / lm[ok, 2])
    err = np.linalg.norm(lm[ok] * scale - np.asarray(X)[ok], axis=-1)
    assert np.median(err) < 0.05, np.median(err)

    # Outliers rejected.
    assert ok[:20].mean() < 0.5


def test_pure_rotation_fails_parallax_gate():
    key = jax.random.PRNGKey(1)
    ks = jax.random.split(key, 3)
    X = jnp.stack([
        jax.random.uniform(ks[0], (300,), minval=-1.2, maxval=1.2),
        jax.random.uniform(ks[1], (300,), minval=-0.9, maxval=0.9),
        jax.random.uniform(ks[2], (300,), minval=2.0, maxval=5.0),
    ], -1)
    T_rot = se3.exp(jnp.array([0.0, 0.05, 0.02, 0.0, 0.0, 0.0]))
    ref_uv = cameras.project(CAM, X)
    cur_uv = cameras.project(CAM, se3.apply(T_rot, X))
    state = make_state(ref_uv, cur_uv)
    res = ini.try_initialize(CAM, state, CFG, jax.random.PRNGKey(0))
    assert not bool(res.success)


def test_kmeans_partitions():
    pts = jnp.concatenate([
        jax.random.normal(jax.random.PRNGKey(0), (50, 2)) + jnp.array([10.0, 0]),
        jax.random.normal(jax.random.PRNGKey(1), (50, 2)) + jnp.array([-10.0, 0]),
    ])
    lbl = ini._kmeans(pts, jnp.ones(100, bool), 2, 10, jax.random.PRNGKey(2))
    l0 = np.asarray(lbl[:50])
    l1 = np.asarray(lbl[50:])
    assert (l0 == l0[0]).mean() > 0.9
    assert (l1 == l1[0]).mean() > 0.9
    assert l0[0] != l1[0]
