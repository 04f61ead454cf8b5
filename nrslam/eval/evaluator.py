"""Per-frame depth-RMSE evaluation against ground truth.

Re-derivation of /root/reference/modules/utilities/frame_evaluator.cc for the
precomputed-depth path (the one active in the reference, system.cc:179-184):
ground-truth depths come from bilinear interpolation of a depth image at the
tracked keypoints; the metric is an IQR-trimmed, iteratively scale-aligned
depth RMSE (10 Gauss-Newton iterations on a scalar scale, 95% inlier trim —
frame_evaluator.cc:134-226).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3
from nrslam.ops import image as image_ops
from nrslam.ops import klt
from nrslam.utils import stats
from nrslam.utils.precision import highest_precision


@partial(jax.jit, static_argnames=("inlier_fraction", "iqr_reject"))
@highest_precision
def _scale_aligned_rmse(est, gt, valid, inlier_fraction=0.95,
                        iqr_reject=False):
    """Iteratively scale-aligned depth RMSE over masked arrays
    (the 10-GN-iteration core of frame_evaluator.cc:134-226).

    ``iqr_reject`` applies the reference's stereo-GT pre-filter: depths whose
    absolute error exceeds q3 + 1.5*IQR are discarded before alignment
    (frame_evaluator.cc:138-159; skipped for precomputed depth). Stereo runs
    should also pass ``inlier_fraction=0.9`` (frame_evaluator.cc:162)."""
    valid = valid & jnp.isfinite(gt) & jnp.isfinite(est)
    if iqr_reject:
        err = jnp.abs(est - gt)
        th = stats.iqr_upper_threshold(err, valid)
        valid = valid & (err <= th)
    n_valid = jnp.sum(valid.astype(jnp.float32))
    n_inliers = jnp.maximum(n_valid * inlier_fraction, 1.0)
    scale = jnp.float32(1.0)

    def gn_step(scale, _):
        r = gt - scale * est
        r2 = jnp.where(valid, r * r, jnp.inf)
        r2_sorted = jnp.sort(r2)
        k = jnp.clip(n_inliers.astype(jnp.int32) - 1, 0, r2.shape[0] - 1)
        th = r2_sorted[k]
        inl = valid & (r2 <= th)
        w = inl.astype(jnp.float32)
        H = jnp.sum(w * est * est)
        g = jnp.sum(w * (-r * est))
        scale = scale - g / jnp.maximum(H, 1e-12)
        r_aligned = gt - scale * est
        rmse = jnp.sqrt(jnp.sum(w * r_aligned * r_aligned)
                        / jnp.maximum(jnp.sum(w), 1.0))
        return scale, rmse

    scale, rmses = jax.lax.scan(gn_step, scale, None, length=10)
    return rmses[-1]


@partial(jax.jit, static_argnames=("cam_kind", "inlier_fraction"))
@highest_precision
def _depth_rmse_impl(keypoints, positions, valid, Tcw, depth_image,
                     cam_params, cam_kind, inlier_fraction=0.95):
    cam = cameras.Camera(cam_params, cam_kind)
    est = se3.apply(Tcw, positions)[..., 2]

    gt_depth = image_ops.bilinear_sample(depth_image, keypoints)
    ray = cameras.unproject(cam, keypoints)
    gt = (ray / ray[..., 2:3])[..., 2] * gt_depth  # z of the GT point
    valid = valid & jnp.isfinite(gt) & jnp.isfinite(est)

    # IQR trim on |est - gt| — with precomputed depth the reference keeps
    # everything (precomputed_depth_ short-circuits the trim,
    # frame_evaluator.cc:158-166) but applies the 95% inlier GN alignment.
    scale = jnp.float32(1.0)
    n_valid = jnp.sum(valid.astype(jnp.float32))
    n_inliers = jnp.maximum(n_valid * inlier_fraction, 1.0)

    def gn_step(scale, _):
        r = gt - scale * est
        r2 = jnp.where(valid, r * r, jnp.inf)
        r2_sorted = jnp.sort(r2)
        k = jnp.clip(n_inliers.astype(jnp.int32) - 1, 0, r2.shape[0] - 1)
        th = r2_sorted[k]
        inl = valid & (r2 <= th)
        w = inl.astype(jnp.float32)
        H = jnp.sum(w * est * est)
        g = jnp.sum(w * (-r * est))
        delta = -g / jnp.maximum(H, 1e-12)
        scale = scale + delta
        r_aligned = gt - scale * est
        rmse = jnp.sqrt(jnp.sum(w * r_aligned * r_aligned)
                        / jnp.maximum(jnp.sum(w), 1.0))
        return scale, rmse

    scale, rmses = jax.lax.scan(gn_step, scale, None, length=10)
    return rmses[-1], scale


class FrameEvaluator:
    """Accumulates per-frame RMSE like the reference's results file.

    Device scalars are held un-materialized per frame; access
    (``rmse_history``/``save``) stacks the pending scalars and fetches them
    with ONE ``jax.device_get`` instead of one device-to-host round trip
    per frame. Pending buffers are flushed to host every
    ``flush_every`` frames so live device buffers stay bounded on long runs.

    Frames evaluated after the device-side collapse latch fired
    (``state.lost``) are recorded as NaN and dropped from the history — the
    reference's results file simply ends at the collapse frame (it exits,
    tracking.cc:97-99)."""

    def __init__(self, flush_every: int = 256):
        self._rmse_dev = []
        self._scale_dev = []
        self._rmse_host = []
        self._scale_host = []
        self._flush_every = flush_every

    def _flush(self):
        if self._rmse_dev:
            r, s = jax.device_get((jnp.stack(self._rmse_dev),
                                   jnp.stack(self._scale_dev)))
            self._rmse_host.extend(r.tolist())
            self._scale_host.extend(s.tolist())
            self._rmse_dev = []
            self._scale_dev = []

    def evaluate(self, state, cam: cameras.Camera, depth_image):
        """Returns the frame's RMSE as an un-materialized device scalar."""
        valid = state.slot_used & (state.status == 0)  # TRACKED_WITH_3D
        rmse, scale = _depth_rmse_impl(
            state.keypoints, state.positions, valid, state.Tcw, depth_image,
            cam.params, cam.kind)
        rmse = jnp.where(state.lost, jnp.nan, rmse)
        self._rmse_dev.append(rmse)
        self._scale_dev.append(scale)
        if len(self._rmse_dev) >= self._flush_every:
            self._flush()
        return rmse

    @property
    def rmse_history(self):
        self._flush()
        import math
        return [r for r in self._rmse_host if math.isfinite(r)]

    @property
    def scale_history(self):
        self._flush()
        import math
        return [s for s, r in zip(self._scale_host, self._rmse_host)
                if math.isfinite(r)]

    def save(self, path):
        with open(path, "w") as f:
            for r in self.rmse_history:
                f.write(f"{r}\n")
