import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import se3, triangulation


def test_midpoint_recovers_points():
    key = jax.random.PRNGKey(0)
    X = jnp.stack([
        jax.random.uniform(key, (32,), minval=-1, maxval=1),
        jax.random.uniform(jax.random.PRNGKey(1), (32,), minval=-1, maxval=1),
        jax.random.uniform(jax.random.PRNGKey(2), (32,), minval=2, maxval=5),
    ], axis=-1)
    T1w = se3.identity()
    # camera 2: translated + slightly rotated
    T2w = se3.exp(jnp.array([0.02, -0.03, 0.01, 0.5, 0.1, -0.2]))

    rays1 = se3.apply(T1w, X)
    rays2 = se3.apply(T2w, X)
    rays1 = rays1 / jnp.linalg.norm(rays1, axis=-1, keepdims=True)
    rays2 = rays2 / jnp.linalg.norm(rays2, axis=-1, keepdims=True)

    Xhat = triangulation.triangulate_midpoint(rays1, rays2, T1w, T2w)
    np.testing.assert_allclose(Xhat, X, atol=1e-3)


def test_parallax():
    r1 = jnp.array([[0.0, 0.0, 1.0]])
    r2 = jnp.array([[jnp.sin(0.1), 0.0, jnp.cos(0.1)]])
    p = triangulation.rays_parallax(r1, r2)
    np.testing.assert_allclose(p, [0.1], atol=1e-5)


def test_parallax_clamps_cosine():
    r = jnp.array([[0.0, 0.0, 1.0]])
    p = triangulation.rays_parallax(r, r * 1.0000001)
    assert np.isfinite(np.asarray(p)).all()
