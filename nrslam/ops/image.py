"""Image-processing device kernels: grayscale, CLAHE, pyramids, sampling.

Device replacements for the OpenCV preprocessing in the reference:
- grayscale + CLAHE (clip 3.0, 8x8 tiles): /root/reference/modules/SLAM/system.cc:37,189-200
- cv::buildOpticalFlowPyramid (5-tap Gaussian pyrDown + Scharr derivatives):
  used by /root/reference/modules/matching/lucas_kanade_tracker.cc:50,196
- bilinear interpolation: /root/reference/modules/utilities/geometry_toolbox.h:46-60

All kernels operate on float32 images in [0, 255] with shape [H, W] and are
fully jittable with static shapes. Out-of-bounds samples clamp to the border
(the pipeline separately gates points near borders, so clamping only has to
be finite, matching cv::BORDER_REFLECT-ish behavior closely enough).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp


def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] uint8/float RGB -> [H, W] float32 gray (OpenCV weights)."""
    rgb = rgb.astype(jnp.float32)
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def clahe(image: jnp.ndarray, clip_limit: float = 3.0, grid: int = 8,
          n_bins: int = 256) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization.

    Tile-based with bilinear interpolation between tile LUTs, the same
    algorithm as cv::createCLAHE(3.0, Size(8, 8)) applied at
    system.cc:189-200. Histogram computation is a one-hot reduction per tile
    (elementwise); excess above the clip limit is redistributed uniformly.

    Requires H and W divisible by ``grid`` (callers pad/crop; the datasets in
    this project use even tile-aligned sizes).
    """
    H, W = image.shape
    th, tw = H // grid, W // grid
    x = jnp.clip(image, 0.0, 255.0)

    tiles = x.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3).reshape(grid * grid, th * tw)
    # Per-tile histogram via one-hot scatter: [T, n_bins]
    bins = jnp.clip((tiles * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1)
    hist = jax.vmap(lambda b: jnp.zeros(n_bins, jnp.float32).at[b].add(1.0))(bins)

    # Clip and redistribute (single pass, as OpenCV does).
    clip = clip_limit * (th * tw) / n_bins
    clip = jnp.maximum(clip, 1.0)
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=-1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / n_bins

    cdf = jnp.cumsum(hist, axis=-1)
    scale = (n_bins - 1.0) / (th * tw)
    luts = jnp.round(cdf * scale)  # [T, n_bins]
    luts = luts.reshape(grid, grid, n_bins)

    # Bilinear interpolation of tile LUT outputs at every pixel.
    yy = (jnp.arange(H, dtype=jnp.float32) + 0.5) / th - 0.5
    xx = (jnp.arange(W, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, grid - 1)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, grid - 1)
    y1 = jnp.clip(y0 + 1, 0, grid - 1)
    x1 = jnp.clip(x0 + 1, 0, grid - 1)
    wy = jnp.clip(yy - jnp.floor(yy), 0.0, 1.0)
    wx = jnp.clip(xx - jnp.floor(xx), 0.0, 1.0)
    wy = jnp.where(yy < 0, 0.0, jnp.where(yy > grid - 1, 1.0, wy))[:, None]
    wx = jnp.where(xx < 0, 0.0, jnp.where(xx > grid - 1, 1.0, wx))[None, :]

    pix_bin = jnp.clip((x * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1)

    # Gather LUT values for the four neighboring tiles: [H, W]
    def gather(tyi, txi):
        # luts[tyi[h], txi[w], pix_bin[h, w]]
        return luts[tyi[:, None], txi[None, :], pix_bin]

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11))
    return out.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Pyramid + gradients
# ---------------------------------------------------------------------------

_PYRDOWN_K = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], jnp.float32) / 16.0


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """Gaussian blur ([1,4,6,4,1]/16 separable) then 2x decimation (cv::pyrDown).

    Written as shifted-slice arithmetic rather than lax.conv: at these image
    sizes the conv path pays layout-transform + dispatch overhead per call,
    while the slice form fuses into a couple of elementwise kernels.
    Rows are decimated between the two 1-D passes (decimation along one axis
    commutes with blurring along the other), halving the column-pass work.
    """
    k = _PYRDOWN_K
    x = jnp.pad(img, ((2, 2), (2, 2)), mode="edge")
    r = (k[0] * x[:-4] + k[1] * x[1:-3] + k[2] * x[2:-2]
         + k[3] * x[3:-1] + k[4] * x[4:])          # vertical blur [H, W+4]
    r = r[::2]                                      # decimate rows first
    b = (k[0] * r[:, :-4] + k[1] * r[:, 1:-3] + k[2] * r[:, 2:-2]
         + k[3] * r[:, 3:-1] + k[4] * r[:, 4:])    # horizontal blur
    return b[:, ::2]


def scharr_gradients(img: jnp.ndarray) -> jnp.ndarray:
    """Scharr x/y derivatives, stacked [H, W, 2].

    cv::buildOpticalFlowPyramid's derivative images use the 3x3 Scharr kernel
    (smoothing [3, 10, 3], difference [-1, 0, 1]) without normalization, so a
    unit intensity ramp produces gradient 32. The KLT kernel relies on this
    exact scaling for its threshold semantics (see ops/klt.py).

    Shifted-slice stencils (see pyr_down) — both derivatives fuse into one
    elementwise kernel over the padded image.
    """
    x = jnp.pad(img, ((1, 1), (1, 1)), mode="edge")
    dx = x[:, 2:] - x[:, :-2]                       # [H+2, W]
    gx = 3.0 * dx[:-2] + 10.0 * dx[1:-1] + 3.0 * dx[2:]
    dy = x[2:, :] - x[:-2, :]                       # [H, W+2]
    gy = 3.0 * dy[:, :-2] + 10.0 * dy[:, 1:-1] + 3.0 * dy[:, 2:]
    return jnp.stack([gx, gy], axis=-1)


def build_pyramid(img: jnp.ndarray, num_levels: int):
    """List of (image, gradients) per level, level 0 = full resolution.

    Functional equivalent of cv::buildOpticalFlowPyramid with derivatives.
    Returns a list of tuples ([H_l, W_l], [H_l, W_l, 2]); shapes halve per
    level so this is a Python-level list (static under jit).
    """
    levels = []
    cur = img
    for _ in range(num_levels):
        levels.append((cur, scharr_gradients(cur)))
        cur = pyr_down(cur)
    return levels


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def bilinear_sample(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Sample [H, W] or [H, W, C] image at continuous (x, y) positions.

    ``uv[..., 0]`` is x (column), ``uv[..., 1]`` is y (row) — OpenCV
    convention. Coordinates are clamped to the valid interpolation domain.
    Returns samples with shape ``uv.shape[:-1]`` (+ [C] if channels present).
    """
    H, W = img.shape[0], img.shape[1]
    x = jnp.clip(uv[..., 0], 0.0, W - 1.0)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.0)
    x0 = jnp.minimum(jnp.floor(x).astype(jnp.int32), W - 2)
    y0 = jnp.minimum(jnp.floor(y).astype(jnp.int32), H - 2)
    fx = x - x0
    fy = y - y0
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def gather_windows(img: jnp.ndarray, centers: jnp.ndarray, win: int) -> jnp.ndarray:
    """Gather win x win bilinear windows around continuous centers.

    Args:
      img: [H, W] or [H, W, C].
      centers: [P, 2] (x, y) window centers (the window spans
        ``center - (win-1)/2 .. center + (win-1)/2``).
      win: static window size.

    Returns [P, win, win] (or [P, win, win, C]).
    This is the shared sampling primitive for KLT, SSIM gating and patch
    precomputation (lucas_kanade_tracker.cc:104-148 inner loops).
    """
    half = (win - 1) * 0.5
    offs = jnp.arange(win, dtype=jnp.float32) - half
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")  # [win, win]
    grid = jnp.stack([ox, oy], axis=-1)  # [win, win, 2] (x, y)
    uv = centers[:, None, None, :] + grid[None, :, :, :]
    return bilinear_sample(img, uv)


def erode(mask: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Binary erosion with a ksize x ksize rectangular structuring element.

    Replaces cv::erode in the masking filters
    (/root/reference/modules/masking/*.cc). ``mask`` is bool [H, W].
    Out-of-image neighborhood counts as False (so borders erode inward).
    """
    # Separable: two 1D min passes (XLA does not factor reduce_window; the
    # masker's 21x21 erosion runs per frame on masked configurations).
    pad = ksize // 2
    x = jnp.pad(mask.astype(jnp.float32),
                ((pad, ksize - 1 - pad), (pad, ksize - 1 - pad)))
    x = jax.lax.reduce_window(
        x, jnp.inf, jax.lax.min, (ksize, 1), (1, 1), "VALID")
    out = jax.lax.reduce_window(
        x, jnp.inf, jax.lax.min, (1, ksize), (1, 1), "VALID")
    return out > 0.5


def dilate(mask: jnp.ndarray, ksize: int) -> jnp.ndarray:
    # Separable: two 1D max passes instead of one ksize^2 window (XLA does
    # not factor reduce_window itself; at the 31x31 occupied-suppression
    # window this is ~15x less work).
    pad = ksize // 2
    x = jnp.pad(mask.astype(jnp.float32),
                ((pad, ksize - 1 - pad), (pad, ksize - 1 - pad)))
    x = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (ksize, 1), (1, 1), "VALID")
    out = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, ksize), (1, 1), "VALID")
    return out > 0.5


def gaussian_blur(img: jnp.ndarray, ksize: int, sigma: float = 0.0) -> jnp.ndarray:
    """Separable Gaussian blur (cv::GaussianBlur semantics for sigma=0).

    Shifted-slice taps instead of lax.conv (see shi_tomasi._tap3); the
    BrightFilter masker runs this per frame."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    xs = jnp.arange(-r, r + 1, dtype=jnp.float32)
    k = jnp.exp(-(xs * xs) / (2 * sigma * sigma))
    k = k / jnp.sum(k)

    x = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    x = sum(k[i] * x[i:i + img.shape[0], :] for i in range(ksize))
    x = jnp.pad(x, ((0, 0), (r, r)), mode="edge")
    return sum(k[i] * x[:, i:i + img.shape[1]] for i in range(ksize))
