import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras
from nrslam.ops import dbscan, masking, stereo


def test_dbscan_two_clusters_and_noise():
    pts = jnp.concatenate([
        jax.random.normal(jax.random.PRNGKey(0), (30, 3)) * 0.3,
        jax.random.normal(jax.random.PRNGKey(1), (20, 3)) * 0.3 + 20.0,
        jnp.array([[100.0, -100.0, 50.0]]),
    ])
    lbl = np.asarray(dbscan.dbscan_3d(pts, eps=2.5))
    # biggest cluster relabeled 0
    assert (lbl[:30] == 0).mean() > 0.9
    assert (lbl[30:50] == 1).mean() > 0.9
    assert lbl[50] == -1


def test_dbscan_respects_valid_mask():
    pts = jnp.zeros((10, 3))
    valid = jnp.arange(10) < 5
    lbl = np.asarray(dbscan.dbscan_3d(pts, valid))
    assert (lbl[5:] == -1).all()
    assert (lbl[:5] == 0).all()


def test_bright_filter_masks_specular():
    img = jnp.full((64, 64), 100.0).at[20:30, 20:30].set(255.0)
    mask = masking.bright_filter(img)
    assert not bool(mask[25, 25])
    assert bool(mask[50, 50])


def test_border_filter():
    img = jnp.full((64, 64), 100.0)
    mask = masking.border_filter(img, rows=5, cols=5)
    assert not bool(mask[6, 32])  # within eroded border
    assert bool(mask[32, 32])


def test_masker_combines():
    img = jnp.full((64, 64), 100.0).at[30:40, 30:40].set(255.0)
    masker = masking.Masker([("BorderFilter", 2, 2), ("BrightFilter", 220.0)])
    masks = masker.get_all_masks(img)
    assert set(masks) == {"BorderFilter", "BrightFilter", "Global"}
    assert not bool(masks["Global"][35, 35])


def _stereo_pair(seed=0, h=96, w=128, disparity=8.0):
    key = jax.random.PRNGKey(seed)
    base = jax.random.uniform(key, (h // 4, w // 4)) * 255
    img = jnp.kron(base, jnp.ones((4, 4)))
    from nrslam.ops import image as image_ops
    img = image_ops.gaussian_blur(img, 5)
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    right = image_ops.bilinear_sample(img, jnp.stack([xs + disparity, ys], -1))
    return img, right


def test_stereo_klt_depth():
    cam = cameras.pinhole(100.0, 100.0, 64.0, 48.0)
    bf = 100.0 * 0.05
    left, right = _stereo_pair()
    kps = jnp.array([[40.0, 40.0], [70.0, 50.0], [90.0, 60.0]])
    valid = jnp.ones(3, bool)
    from nrslam.ops import klt as klt_mod
    cfg = klt_mod.KLTConfig(win=15, max_level=2)
    X, ok = stereo.stereo_lucas_kanade(cam, bf, left, right, kps, valid, cfg)
    ok = np.asarray(ok)
    assert ok.sum() >= 2
    expected_depth = bf / 8.0
    np.testing.assert_allclose(np.asarray(X)[ok, 2], expected_depth, rtol=0.05)


def test_stereo_ncc_depth():
    cam = cameras.pinhole(100.0, 100.0, 64.0, 48.0)
    bf = 100.0 * 0.05
    left, right = _stereo_pair(seed=3)
    kps = jnp.array([[50.0, 40.0], [80.0, 55.0]])
    valid = jnp.ones(2, bool)
    X, ok = stereo.stereo_pattern_matching(cam, bf, left, right, kps, valid,
                                           max_disparity=32)
    ok = np.asarray(ok)
    assert ok.sum() >= 1
    expected_depth = bf / 8.0
    np.testing.assert_allclose(np.asarray(X)[ok, 2], expected_depth, rtol=0.05)
