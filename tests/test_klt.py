import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrslam.ops import klt
from nrslam.ops import shi_tomasi


def textured_image(h=120, w=160, seed=0):
    """Smooth random texture with plenty of gradient structure."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4, w // 4) * 255
    import scipy.ndimage as ndi  # available via scipy in the image? fall back
    img = np.kron(base, np.ones((4, 4)))
    # smooth a little so bilinear shifts are well-modelled
    k = np.array([1, 4, 6, 4, 1]) / 16.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    return jnp.asarray(img, jnp.float32)


def shift_image(img, dx, dy):
    """Bilinear shift: output(x, y) = input(x - dx, y - dy)."""
    h, w = img.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    from nrslam.ops import image as image_ops
    uv = jnp.stack([xs - dx, ys - dy], axis=-1)
    return image_ops.bilinear_sample(img, uv)


CFG = klt.KLTConfig(win=21, max_level=3, max_iters=10, epsilon=1e-4,
                    min_eig_threshold=1e-4)


def grid_points(h, w, margin=25, step=20):
    xs = np.arange(margin, w - margin, step, dtype=np.float32)
    ys = np.arange(margin, h - margin, step, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1))


def test_klt_recovers_translation():
    img = textured_image()
    dx, dy = 3.3, -2.6
    img2 = shift_image(img, dx, dy)

    pts = grid_points(*img.shape)
    valid = jnp.ones(pts.shape[0], bool)
    pyr1 = klt.build_pyramid(img, CFG)
    pyr2 = klt.build_pyramid(img2, CFG)
    refs = klt.set_reference(pyr1, pts, valid, CFG)

    statuses = jnp.full(pts.shape[0], klt.TRACKED, jnp.int32)
    out_pts, out_status = klt.track(pyr2, refs, pts, statuses, CFG, min_ssim=0.5)

    ok = np.asarray(klt.is_usable(out_status))
    assert ok.mean() > 0.8, f"only {ok.mean():.2f} tracked"
    flow = np.asarray(out_pts - pts)[ok]
    err = np.abs(flow - np.array([dx, dy]))
    assert np.median(err[:, 0]) < 0.15 and np.median(err[:, 1]) < 0.15, (
        np.median(err, axis=0))


def test_klt_gain_bias_invariance():
    img = textured_image(seed=1)
    dx, dy = 1.7, 2.1
    img2 = jnp.clip(shift_image(img, dx, dy) * 1.25, 0, 255)

    pts = grid_points(*img.shape)
    valid = jnp.ones(pts.shape[0], bool)
    refs = klt.set_reference(klt.build_pyramid(img, CFG), pts, valid, CFG)
    statuses = jnp.full(pts.shape[0], klt.TRACKED, jnp.int32)
    out_pts, out_status = klt.track(klt.build_pyramid(img2, CFG), refs, pts,
                                    statuses, CFG, min_ssim=0.5)
    ok = np.asarray(klt.is_usable(out_status))
    assert ok.mean() > 0.7
    flow = np.asarray(out_pts - pts)[ok]
    err = np.abs(flow - np.array([dx, dy]))
    assert np.median(err[:, 0]) < 0.25 and np.median(err[:, 1]) < 0.25


def test_klt_flat_region_is_bad_feature():
    img = jnp.full((120, 160), 128.0)
    pts = jnp.array([[80.0, 60.0]])
    valid = jnp.ones(1, bool)
    refs = klt.set_reference(klt.build_pyramid(img, CFG), pts, valid, CFG)
    statuses = jnp.full(1, klt.TRACKED, jnp.int32)
    _, out_status = klt.track(klt.build_pyramid(img, CFG), refs, pts, statuses,
                              CFG, min_ssim=0.5)
    assert int(out_status[0]) == klt.BAD_FEATURE


def test_klt_border_point_out_of_bounds():
    img = textured_image()
    pts = jnp.array([[3.0, 3.0]])
    valid = jnp.ones(1, bool)
    refs = klt.set_reference(klt.build_pyramid(img, CFG), pts, valid, CFG)
    statuses = jnp.full(1, klt.TRACKED, jnp.int32)
    _, out_status = klt.track(klt.build_pyramid(img, CFG), refs, pts, statuses,
                              CFG, min_ssim=0.5)
    assert int(out_status[0]) == klt.OUT_IMAGE_BOUNDARIES


def test_klt_against_opencv():
    cv2 = pytest.importorskip("cv2")
    img = textured_image(seed=2)
    img2 = shift_image(img, 2.4, 1.2)
    pts = grid_points(*img.shape)

    im8 = np.asarray(img, np.uint8)
    im8b = np.asarray(img2, np.uint8)
    p0 = np.asarray(pts, np.float32).reshape(-1, 1, 2)
    p1, st, _ = cv2.calcOpticalFlowPyrLK(
        im8, im8b, p0, None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 0.01))

    pyr1 = klt.build_pyramid(jnp.asarray(im8, jnp.float32), CFG)
    pyr2 = klt.build_pyramid(jnp.asarray(im8b, jnp.float32), CFG)
    refs = klt.set_reference(pyr1, pts, jnp.ones(pts.shape[0], bool), CFG)
    statuses = jnp.full(pts.shape[0], klt.TRACKED, jnp.int32)
    out_pts, out_status = klt.track(pyr2, refs, pts, statuses, CFG, min_ssim=0.3)

    both = (st.ravel() == 1) & np.asarray(klt.is_usable(out_status))
    assert both.mean() > 0.7
    d = np.linalg.norm(np.asarray(out_pts)[both] - p1.reshape(-1, 2)[both], axis=-1)
    assert np.median(d) < 0.3, np.median(d)


def test_shi_tomasi_detects_checkerboard_corners():
    # checkerboard with 20-px squares
    h, w = 120, 160
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = jnp.asarray((((yy // 20) + (xx // 20)) % 2) * 255.0, jnp.float32)
    xy, valid, scores = shi_tomasi.detect(img, max_keypoints=64, nms_radius=7)
    xy = np.asarray(xy)[np.asarray(valid)]
    assert len(xy) >= 20
    # every detection should be near a 20-px grid crossing
    offs = np.abs((xy + 10.0) % 20.0 - 10.0)
    assert np.percentile(offs.max(axis=-1), 90) <= 2.0


def test_shi_tomasi_occupied_suppression():
    h, w = 120, 160
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = jnp.asarray((((yy // 20) + (xx // 20)) % 2) * 255.0, jnp.float32)
    xy0, valid0, _ = shi_tomasi.detect(img, max_keypoints=64, nms_radius=7)
    occupied = jnp.zeros((h, w), bool)
    for x, y in np.asarray(xy0)[np.asarray(valid0)]:
        occupied = occupied.at[int(y), int(x)].set(True)
    xy1, valid1, _ = shi_tomasi.detect(img, max_keypoints=64, nms_radius=7,
                                       occupied=occupied)
    pts1 = np.asarray(xy1)[np.asarray(valid1)]
    pts0 = np.asarray(xy0)[np.asarray(valid0)]
    if len(pts1):
        dists = np.min(np.linalg.norm(pts1[:, None] - pts0[None], axis=-1), axis=-1)
        assert dists.min() > shi_tomasi.OUTER_RADIUS


@pytest.mark.parametrize("channels", [None, 2], ids=["gray", "multichannel"])
def test_extract_patches_equals_direct_indexing(channels):
    """One-hot patch extraction is exact: every output sums a single
    nonzero product, including rows/cols clamped at the image border."""
    h, w, size = 37, 53, 9
    key = jax.random.PRNGKey(3)
    shape = (h, w) if channels is None else (h, w, channels)
    img = 255.0 * jax.random.uniform(key, shape)
    y0 = jnp.array([-4, 0, 10, 30, 33], jnp.int32)
    x0 = jnp.array([-2, 47, 5, 20, 50], jnp.int32)
    out = np.asarray(jax.jit(klt._extract_patches, static_argnums=3)(
        img, y0, x0, size))
    rows = np.clip(np.asarray(y0)[:, None] + np.arange(size), 0, h - 1)
    cols = np.clip(np.asarray(x0)[:, None] + np.arange(size), 0, w - 1)
    ref = np.asarray(img)[rows[:, :, None], cols[:, None, :]]
    np.testing.assert_array_equal(out, ref)
