import numpy as np
import pytest

from nrslam.datasets import native_loader


pytestmark = pytest.mark.skipif(not native_loader.build(),
                                reason="native toolchain unavailable")


@pytest.fixture
def png_dir(tmp_path):
    cv2 = pytest.importorskip("cv2")
    paths = []
    rng = np.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(32, 48, 3) * 255).astype(np.uint8)
        p = tmp_path / f"{i:03d}.png"
        cv2.imwrite(str(p), img)
        paths.append((str(p), img))
    return paths


def test_decode_matches_luma(png_dir):
    path, img = png_dir[0]
    out = native_loader.decode(path)
    # cv2 writes BGR; decoder reads RGB channel order from the PNG
    ref = 0.299 * img[:, :, 2] + 0.587 * img[:, :, 1] + 0.114 * img[:, :, 0]
    assert out.shape == (32, 48)
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_prefetch_order_and_count(png_dir):
    paths = [p for p, _ in png_dir]
    ldr = native_loader.PrefetchLoader(paths, n_threads=3, capacity=4)
    frames = list(ldr)
    assert len(frames) == len(paths)
    for (path, img), frame in zip(png_dir, frames):
        ref = 0.299 * img[:, :, 2] + 0.587 * img[:, :, 1] + 0.114 * img[:, :, 0]
        np.testing.assert_allclose(frame, ref, atol=1e-3)


def test_missing_file_decode():
    assert native_loader.decode("/nonexistent/zzz.png") is None
