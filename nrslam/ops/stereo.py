"""Stereo matchers: KLT-based and NCC pattern matching.

Batched re-design of /root/reference/modules/stereo/ (used for stereo
initialization experiments and ground-truth generation for evaluation):

- ``stereo_lucas_kanade``: track keypoints left -> right on a rectified pair,
  gate on row agreement (< 2 px) and positive disparity, depth = bf/disparity
  (stereo_lucas_kanade.cc:39-75).
- ``stereo_pattern_matching``: normalized cross-correlation search along the
  epipolar row, accept at corr > 0.99, depth = bf/disparity
  (stereo_pattern_matching.cc:33-93).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras
from nrslam.ops import image as image_ops
from nrslam.ops import klt


def stereo_lucas_kanade(cam: cameras.Camera, bf: float, left: jnp.ndarray,
                        right: jnp.ndarray, keypoints: jnp.ndarray,
                        valid: jnp.ndarray,
                        config: klt.KLTConfig = klt.KLTConfig(),
                        min_ssim: float = 0.5):
    """KLT left->right + disparity depth. Returns (points3d [P, 3], ok [P])."""
    pyr_l = klt.build_pyramid(left, config)
    pyr_r = klt.build_pyramid(right, config)
    refs = klt.set_reference(pyr_l, keypoints, valid, config)
    status0 = jnp.where(valid, klt.TRACKED, klt.BAD).astype(jnp.int32)
    pts_r, status = klt.track(pyr_r, refs, keypoints, status0, config,
                              min_ssim=min_ssim)

    row_gap = jnp.abs(pts_r[:, 1] - keypoints[:, 1])
    disparity = keypoints[:, 0] - pts_r[:, 0]
    ok = (valid & klt.is_usable(status) & (row_gap < 2.0) & (disparity > 0))
    depth = bf / jnp.maximum(disparity, 1e-6)
    ray = cameras.unproject(cam, keypoints)
    ray = ray / ray[..., 2:3]
    return ray * depth[:, None], ok


def stereo_pattern_matching(cam: cameras.Camera, bf: float, left: jnp.ndarray,
                            right: jnp.ndarray, keypoints: jnp.ndarray,
                            valid: jnp.ndarray, win: int = 11,
                            max_disparity: int = 96,
                            min_corr: float = 0.99):
    """NCC template search along the rectified epipolar line.

    Returns (points3d [P, 3], ok [P]). The subpixel peak is refined by a
    parabola fit over the correlation triplet around the argmax.
    """
    half = (win - 1) / 2.0
    tmpl = image_ops.gather_windows(left, keypoints, win)      # [P, w, w]
    tmpl = tmpl - jnp.mean(tmpl, axis=(-2, -1), keepdims=True)
    tnorm = jnp.sqrt(jnp.sum(tmpl * tmpl, axis=(-2, -1)) + 1e-12)

    disps = jnp.arange(max_disparity, dtype=jnp.float32)       # candidate d

    def corr_at(d):
        cand = keypoints - jnp.stack([d * jnp.ones(keypoints.shape[0]),
                                      jnp.zeros(keypoints.shape[0])], -1)
        w = image_ops.gather_windows(right, cand, win)
        w = w - jnp.mean(w, axis=(-2, -1), keepdims=True)
        wn = jnp.sqrt(jnp.sum(w * w, axis=(-2, -1)) + 1e-12)
        return jnp.sum(w * tmpl, axis=(-2, -1)) / (wn * tnorm)

    corrs = jax.vmap(corr_at)(disps)                           # [D, P]
    best = jnp.argmax(corrs, axis=0)
    best_corr = jnp.max(corrs, axis=0)

    # Parabolic subpixel refinement.
    D = max_disparity
    bm = jnp.clip(best, 1, D - 2)
    cm1 = corrs[bm - 1, jnp.arange(corrs.shape[1])]
    c0 = corrs[bm, jnp.arange(corrs.shape[1])]
    cp1 = corrs[bm + 1, jnp.arange(corrs.shape[1])]
    denom = cm1 - 2 * c0 + cp1
    offset = jnp.where(jnp.abs(denom) > 1e-9,
                       0.5 * (cm1 - cp1) / denom, 0.0)
    disparity = bm.astype(jnp.float32) + jnp.clip(offset, -1.0, 1.0)

    ok = valid & (best_corr > min_corr) & (disparity > 0.5)
    depth = bf / jnp.maximum(disparity, 1e-6)
    ray = cameras.unproject(cam, keypoints)
    ray = ray / ray[..., 2:3]
    return ray * depth[:, None], ok
