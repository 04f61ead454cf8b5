import jax.numpy as jnp
import numpy as np

from nrslam.utils import stats


def test_masked_median_matches_nth_element():
    x = jnp.array([5.0, 1.0, 9.0, 3.0, 7.0, 100.0])
    mask = jnp.array([True, True, True, True, True, False])
    # reference convention: sorted[n//2] with n=5 -> index 2 -> 5.0
    assert float(stats.masked_median(x, mask)) == 5.0


def test_masked_mean_ignores_invalid():
    x = jnp.array([1.0, 2.0, 1000.0])
    mask = jnp.array([True, True, False])
    np.testing.assert_allclose(stats.masked_mean(x, mask), 1.5)


def test_iqr_threshold():
    x = jnp.arange(100.0)
    mask = jnp.ones(100, bool)
    q1, q3 = 25.0, 75.0
    expected = q3 + 1.5 * (q3 - q1)
    np.testing.assert_allclose(stats.iqr_upper_threshold(x, mask), expected)


def test_chi2_table():
    np.testing.assert_allclose(stats.CHI2_95[1], 5.991, atol=1e-3)
    np.testing.assert_allclose(stats.CHI2_95[2], 7.815, atol=1e-3)
