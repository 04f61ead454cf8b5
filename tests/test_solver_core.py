"""Unit tests for the solver core numerics added in round 2:

closed-form 3x3/6x6 SPD inverses and solves (elementwise replacements for
batched LU), and the bf16/f32 selector matmuls (core.selmm / selmm_exact).
"""

import jax
import jax.numpy as jnp
import numpy as np

from nrslam.solver import core


def _spd(key, n, batch=()):
    A = jax.random.normal(key, batch + (n, n))
    return A @ jnp.swapaxes(A, -1, -2) + 0.5 * jnp.eye(n)


def test_inv3x3_matches_numpy():
    A = _spd(jax.random.PRNGKey(0), 3, (64,))
    inv = core.inv3x3(A)
    np.testing.assert_allclose(np.asarray(inv),
                               np.linalg.inv(np.asarray(A)),
                               rtol=1e-4, atol=1e-5)


def test_inv3x3_unbatched():
    A = _spd(jax.random.PRNGKey(1), 3)
    np.testing.assert_allclose(np.asarray(core.inv3x3(A) @ A), np.eye(3),
                               atol=1e-5)


def test_solve_spd6_matches_numpy():
    H = _spd(jax.random.PRNGKey(2), 6)
    g = jax.random.normal(jax.random.PRNGKey(3), (6,))
    y = core.solve_spd6(H, g)
    np.testing.assert_allclose(np.asarray(y),
                               np.linalg.solve(np.asarray(H), np.asarray(g)),
                               rtol=1e-4, atol=1e-5)


def test_inv_spd6_matches_numpy():
    H = _spd(jax.random.PRNGKey(4), 6, (8,))
    inv = core.inv_spd6(H)
    np.testing.assert_allclose(np.asarray(inv @ H),
                               np.broadcast_to(np.eye(6), (8, 6, 6)),
                               atol=1e-4)


def test_solve_dense_spd6_path():
    H = _spd(jax.random.PRNGKey(5), 6)
    g = jax.random.normal(jax.random.PRNGKey(6), (6,))
    lam = jnp.float32(0.1)
    dx = core.solve_dense(H, g, lam)
    ref = -np.linalg.solve(np.asarray(H) + 0.1 * np.eye(6), np.asarray(g))
    np.testing.assert_allclose(np.asarray(dx), ref, rtol=1e-4, atol=1e-5)


def test_selmm_exact_equals_gather_difference():
    P, E = 50, 200
    key = jax.random.PRNGKey(7)
    i = jax.random.randint(key, (E,), 0, P)
    j = jax.random.randint(jax.random.fold_in(key, 1), (E,), 0, P)
    x = jax.random.normal(jax.random.fold_in(key, 2), (P, 3))
    Si = jax.nn.one_hot(i, P, dtype=jnp.bfloat16)
    Sj = jax.nn.one_hot(j, P, dtype=jnp.bfloat16)
    out = core.selmm_exact("ep,pk->ek", Si - Sj, x)
    ref = x[i] - x[j]
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_selmm_close_on_cpu_fallback():
    # selmm rounds x to bf16 on every backend, the CPU included; a one-hot
    # selection then returns exactly the rounded row, accumulated in f32.
    P, E = 30, 100
    key = jax.random.PRNGKey(8)
    i = jax.random.randint(key, (E,), 0, P)
    S = jax.nn.one_hot(i, P, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.fold_in(key, 1), (P, 4))
    out = core.selmm("ep,pk->ek", S, x)
    assert out.dtype == jnp.float32
    x_bf16 = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(out), x_bf16[np.asarray(i)])


def test_pcg_solves_spd_system():
    n = 40
    H = _spd(jax.random.PRNGKey(9), n)
    b = jax.random.normal(jax.random.PRNGKey(10), (n,))
    x = core.pcg(lambda v: H @ v, b, 1.0 / jnp.diagonal(H), iters=200,
                 tol=1e-10)
    np.testing.assert_allclose(np.asarray(H @ x), np.asarray(b),
                               rtol=1e-3, atol=1e-3)
