import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.geometry import cameras


PIN = cameras.pinhole(472.65, 472.65, 479.5, 359.5)
KB = cameras.kannala_brandt8(383.0, 383.5, 478.3, 269.2,
                             -0.006, 0.043, -0.035, 0.005)


@pytest.mark.parametrize("cam", [PIN, KB], ids=["pinhole", "kb8"])
def test_project_unproject_round_trip(cam):
    key = jax.random.PRNGKey(0)
    uv = jnp.stack([
        100 + 700 * jax.random.uniform(key, (64,)),
        80 + 450 * jax.random.uniform(jax.random.PRNGKey(1), (64,)),
    ], axis=-1)
    rays = cameras.unproject(cam, uv)
    # scale rays by arbitrary positive depth: projection must be invariant
    X = rays * (0.5 + 3.0 * jax.random.uniform(jax.random.PRNGKey(2), (64, 1)))
    uv2 = cameras.project(cam, X)
    np.testing.assert_allclose(uv2, uv, atol=1e-2)


@pytest.mark.parametrize("cam", [PIN, KB], ids=["pinhole", "kb8"])
def test_projection_jacobian_matches_autodiff(cam):
    X = jnp.array([[0.2, -0.1, 1.5], [0.5, 0.4, 2.0], [-0.3, 0.25, 0.8]])
    J_analytic = cameras.projection_jacobian(cam, X)
    J_auto = jax.vmap(jax.jacobian(lambda x: cameras.project(cam, x)))(X)
    np.testing.assert_allclose(J_analytic, J_auto, rtol=1e-3, atol=1e-3)


def test_unit_rays_are_unit():
    uv = jnp.array([[100.0, 200.0], [400.0, 300.0]])
    r = cameras.unit_rays(KB, uv)
    np.testing.assert_allclose(jnp.linalg.norm(r, axis=-1), 1.0, atol=1e-5)


def test_pinhole_center_ray():
    uv = jnp.array([[479.5, 359.5]])
    r = cameras.unproject(PIN, uv)
    np.testing.assert_allclose(r, [[0.0, 0.0, 1.0]], atol=1e-6)
