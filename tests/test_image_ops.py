import jax
import jax.numpy as jnp
import numpy as np

from nrslam.ops import image


def _test_img(h=64, w=96, seed=0):
    key = jax.random.PRNGKey(seed)
    base = 128 + 80 * jnp.sin(jnp.arange(h)[:, None] / 5.0) * jnp.cos(jnp.arange(w)[None, :] / 7.0)
    noise = 10 * jax.random.normal(key, (h, w))
    return jnp.clip(base + noise, 0, 255).astype(jnp.float32)


def test_pyr_down_shapes_and_smoothing():
    img = _test_img(64, 96)
    down = image.pyr_down(img)
    assert down.shape == (32, 48)
    # downsampled mean close to original mean
    np.testing.assert_allclose(jnp.mean(down), jnp.mean(img), rtol=0.05)


def test_scharr_gradient_of_ramp():
    # unit x-ramp must give gradient 32 (Scharr, unnormalized)
    img = jnp.broadcast_to(jnp.arange(64, dtype=jnp.float32), (32, 64))
    g = image.scharr_gradients(img)
    np.testing.assert_allclose(g[5:-5, 5:-5, 0], 32.0, atol=1e-3)
    np.testing.assert_allclose(g[5:-5, 5:-5, 1], 0.0, atol=1e-3)


def test_bilinear_sample_exact_and_interp():
    img = jnp.arange(12.0).reshape(3, 4)
    # exact grid points
    uv = jnp.array([[1.0, 1.0], [2.0, 2.0]])
    np.testing.assert_allclose(image.bilinear_sample(img, uv), [5.0, 10.0])
    # halfway between (1,1)=5 and (2,1)=6
    np.testing.assert_allclose(image.bilinear_sample(img, jnp.array([[1.5, 1.0]])), [5.5])


def test_gather_windows_center():
    img = _test_img(40, 40)
    centers = jnp.array([[20.0, 15.0]])
    win = image.gather_windows(img, centers, 5)
    assert win.shape == (1, 5, 5)
    np.testing.assert_allclose(win[0, 2, 2], img[15, 20], atol=1e-4)


def test_erode_dilate():
    mask = jnp.zeros((16, 16), bool).at[4:12, 4:12].set(True)
    eroded = image.erode(mask, 3)
    assert bool(eroded[5, 5]) and not bool(eroded[4, 4])
    dilated = image.dilate(mask, 3)
    assert bool(dilated[3, 3]) and not bool(dilated[2, 2])


def test_clahe_improves_contrast_and_bounds():
    # low-contrast image
    img = 100 + 20 * jax.random.uniform(jax.random.PRNGKey(0), (64, 64))
    out = image.clahe(img)
    assert out.shape == img.shape
    assert float(jnp.min(out)) >= 0.0 and float(jnp.max(out)) <= 255.0
    assert float(jnp.std(out)) > float(jnp.std(img))  # contrast stretched


def test_clahe_uniform_image_stable():
    img = jnp.full((64, 64), 128.0)
    out = image.clahe(img)
    assert np.isfinite(np.asarray(out)).all()


def test_rgb_to_gray():
    rgb = jnp.stack([jnp.full((4, 4), 255.0), jnp.zeros((4, 4)), jnp.zeros((4, 4))], -1)
    np.testing.assert_allclose(image.rgb_to_gray(rgb), 0.299 * 255, atol=1e-3)
