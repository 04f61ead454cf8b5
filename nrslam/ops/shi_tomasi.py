"""Shi-Tomasi corner detection as a fused device kernel.

Batched re-design of /root/reference/modules/features/shi_tomasi.cc:
Sobel gradients -> 3x3-averaged structure tensor -> min-eigenvalue score ->
two-radius non-maximum suppression, all expressed as convolutions and pooling
(the reference's hand-rolled single-pass C++ becomes a handful of fused XLA
ops). Score threshold 80 and the inner/outer NMS radii (options window / 15)
match shi_tomasi.cc:123-160.

Selection returns a fixed number of slots via top-k with a validity mask —
the device-friendly replacement for the dynamic keypoint vector.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.ops import image as image_ops

SCORE_THRESHOLD = 80.0  # shi_tomasi.cc:142
OUTER_RADIUS = 15       # shi_tomasi.cc:126 (NPrev)


def _tap3(x: jnp.ndarray, k0: float, k1: float, k2: float,
          axis: int) -> jnp.ndarray:
    """3-tap correlation along one axis as shifted-slice adds.

    A single-channel ``lax.conv`` has no channel axis to tile; explicit
    shift-adds are pure elementwise work that fuses with its neighbours."""
    pads = [(0, 0), (0, 0)]
    pads[axis] = (1, 1)
    xp = jnp.pad(x, pads, mode="edge")
    if axis == 0:
        return k0 * xp[:-2, :] + k1 * xp[1:-1, :] + k2 * xp[2:, :]
    return k0 * xp[:, :-2] + k1 * xp[:, 1:-1] + k2 * xp[:, 2:]


def score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Min-eigenvalue score of the 3x3-box-averaged structure tensor.

    Gradients use the Sobel kernel (smooth [1,2,1], diff [-1,0,1]) without
    normalization, matching FastSobelXYandScore (shi_tomasi.cc:163-345);
    the tensor average uses 1/9 (shi_tomasi.h inv_size).
    """
    sm_y = lambda x: _tap3(x, 1.0, 2.0, 1.0, 0)
    sm_x = lambda x: _tap3(x, 1.0, 2.0, 1.0, 1)
    df_y = lambda x: _tap3(x, -1.0, 0.0, 1.0, 0)
    df_x = lambda x: _tap3(x, -1.0, 0.0, 1.0, 1)
    box = lambda x: _tap3(_tap3(x, 1.0, 1.0, 1.0, 0), 1.0, 1.0, 1.0, 1)
    gx = df_x(sm_y(img))
    gy = df_y(sm_x(img))

    g11 = box(gx * gx) / 9.0
    g12 = box(gx * gy) / 9.0
    g22 = box(gy * gy) / 9.0

    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    root = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
    return (tr - root) * 0.5


def _max_pool(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    # Separable: two 1D max passes (XLA does not factor reduce_window; the
    # 15x15 NMS window is ~7x cheaper this way).
    k = 2 * radius + 1
    x = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (k, 1), (1, 1), "SAME")
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, k), (1, 1), "SAME")


def detect(img: jnp.ndarray, max_keypoints: int, nms_radius: int = 7,
           mask: jnp.ndarray | None = None,
           occupied: jnp.ndarray | None = None):
    """Detect up to ``max_keypoints`` corners.

    Args:
      img: [H, W] float32 grayscale.
      max_keypoints: static output capacity.
      nms_radius: inner NMS radius (reference uses 7 for tracking,
        tracking.cc:35; 5 default).
      mask: optional [H, W] bool; detections only where True (the reference
        masks keypoints after extraction, tracking.cc:121-133).
      occupied: optional [H, W] bool map of already-extracted keypoint pixels.
        Candidates within OUTER_RADIUS of an occupied pixel are suppressed
        (score-poisoning in shi_tomasi.cc:90-99 + IsLocalMaximum -1 checks).

    Returns:
      xy: [max_keypoints, 2] float32 pixel positions (x, y).
      valid: [max_keypoints] bool.
      scores: [max_keypoints] float32.
    """
    h, w = img.shape
    s = score_map(img)

    # Border: the reference only writes scores for interior pixels
    # (rows 2..H-2 via its streaming loops); zero out a 1-px frame plus the
    # filter support so maxima never sit on the border.
    interior = jnp.zeros_like(s, dtype=bool).at[2:-2, 2:-2].set(True)

    is_max = (s >= _max_pool(s, nms_radius)) & (s >= SCORE_THRESHOLD) & interior
    if occupied is not None:
        near_occupied = image_ops.dilate(occupied, 2 * OUTER_RADIUS + 1)
        is_max = is_max & ~near_occupied
    if mask is not None:
        is_max = is_max & mask

    # Two-stage top-k: block-reduce to one candidate per BxB tile, then a
    # ~5k-element top_k instead of a full H*W sort. Lossless for NMS
    # survivors: with B = nms_radius + 1, two surviving maxima are more
    # than nms_radius apart (Chebyshev) and cannot share a tile — only
    # exact score ties within the radius could (one of the tie is dropped;
    # the reference's streaming NMS breaks such ties by scan order anyway).
    B = max(2, min(8, nms_radius + 1))
    Hp = -(-h // B) * B
    Wp = -(-w // B) * B
    sm = jnp.where(is_max, s, -jnp.inf)
    sm = jnp.pad(sm, ((0, Hp - h), (0, Wp - w)),
                 constant_values=-jnp.inf)
    tiles = sm.reshape(Hp // B, B, Wp // B, B)
    tiles = jnp.transpose(tiles, (0, 2, 1, 3)).reshape(-1, B * B)
    bmax = jnp.max(tiles, axis=-1)
    barg = jnp.argmax(tiles, axis=-1)
    # Small images / large budgets: cannot select more than one winner per
    # tile — pad the tail with invalid (-inf) entries.
    k_sel = min(max_keypoints, bmax.shape[0])
    top_scores, bidx = jax.lax.top_k(bmax, k_sel)
    if k_sel < max_keypoints:
        pad = max_keypoints - k_sel
        top_scores = jnp.concatenate(
            [top_scores, jnp.full((pad,), -jnp.inf, top_scores.dtype)])
        bidx = jnp.concatenate([bidx, jnp.zeros((pad,), bidx.dtype)])
    within = barg[bidx]
    nbx = Wp // B
    yy = ((bidx // nbx) * B + within // B).astype(jnp.float32)
    xx = ((bidx % nbx) * B + within % B).astype(jnp.float32)
    valid = jnp.isfinite(top_scores)
    xy = jnp.stack([xx, yy], axis=-1)
    return xy, valid, jnp.where(valid, top_scores, 0.0)
