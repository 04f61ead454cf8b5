import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.geometry import se3


def random_se3(key, batch=()):
    k1, k2 = jax.random.split(key)
    q = se3.quat_normalize(jax.random.normal(k1, batch + (4,)))
    t = jax.random.normal(k2, batch + (3,))
    return se3.SE3(q, t)


def test_compose_inverse_identity():
    T = random_se3(jax.random.PRNGKey(0), (7,))
    I = se3.compose(T, se3.inverse(T))
    np.testing.assert_allclose(np.abs(I.q[:, 0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(I.t, 0.0, atol=1e-5)


def test_apply_matches_matrix():
    T = random_se3(jax.random.PRNGKey(1), (5,))
    X = jax.random.normal(jax.random.PRNGKey(2), (5, 3))
    M = se3.to_matrix(T)
    expected = jnp.einsum("bij,bj->bi", M[:, :3, :3], X) + M[:, :3, 3]
    np.testing.assert_allclose(se3.apply(T, X), expected, atol=1e-5)


def test_matrix_round_trip():
    T = random_se3(jax.random.PRNGKey(3), (11,))
    T2 = se3.from_matrix(se3.to_matrix(T))
    np.testing.assert_allclose(se3.to_matrix(T2), se3.to_matrix(T), atol=1e-5)


def test_exp_log_round_trip():
    twist = 0.5 * jax.random.normal(jax.random.PRNGKey(4), (9, 6))
    out = se3.log(se3.exp(twist))
    np.testing.assert_allclose(out, twist, atol=1e-4)


def test_exp_small_angle():
    twist = jnp.array([[1e-9, 0, 0, 0.1, 0.2, 0.3]])
    T = se3.exp(twist)
    np.testing.assert_allclose(T.t, [[0.1, 0.2, 0.3]], atol=1e-6)
    # differentiable at zero
    g = jax.jacobian(lambda w: se3.exp(w).t)(jnp.zeros(6))
    np.testing.assert_allclose(g[:, 3:], np.eye(3), atol=1e-5)
    assert np.all(np.isfinite(np.asarray(g)))


def test_retract_matches_left_multiplication():
    T = random_se3(jax.random.PRNGKey(5))
    d = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (6,))
    R1 = se3.to_matrix(se3.retract(T, d))
    R2 = se3.to_matrix(se3.exp(d)) @ se3.to_matrix(T)
    np.testing.assert_allclose(R1, R2, atol=1e-5)


def test_slerp_endpoints():
    T0 = random_se3(jax.random.PRNGKey(7))
    T1 = random_se3(jax.random.PRNGKey(8))
    S0 = se3.slerp(T0, T1, 0.0)
    S1 = se3.slerp(T0, T1, 1.0)
    np.testing.assert_allclose(se3.to_matrix(S0), se3.to_matrix(T0), atol=1e-5)
    np.testing.assert_allclose(se3.to_matrix(S1), se3.to_matrix(T1), atol=1e-5)


def test_quat_rotate_matches_matrix():
    q = se3.quat_normalize(jax.random.normal(jax.random.PRNGKey(9), (4,)))
    v = jax.random.normal(jax.random.PRNGKey(10), (6, 3))
    R = se3.quat_to_matrix(q)
    np.testing.assert_allclose(se3.quat_rotate(q, v), v @ R.T, atol=1e-5)
