"""Batched pyramidal Lucas-Kanade tracking with illumination invariance.

Batched re-design of the reference's per-point C++ KLT
(/root/reference/modules/matching/lucas_kanade_tracker.cc). All points are
tracked in lockstep as dense [P, ...] arrays; the per-level iteration is a
``lax.fori_loop`` with per-point done/status masks instead of breaks.

Semantics preserved from the reference (trajectory-level, not bit-exact):

- Intensity windows are kept in "ival" units = 32x gray (the reference's
  integer pipeline descales ``pixel * 2^14`` by ``W_BITS1-5 = 9``:
  lucas_kanade_tracker.cc:104-148), and gradients are unnormalized Scharr
  responses (32x slope). With the reference's ``FLT_SCALE = 2^-20`` applied
  to all window sums, every threshold (min-eig 1e-4, epsilon, SSIM C1/C2 on
  /32 windows) then has identical meaning.
- Gain/bias illumination model: ``alpha = sqrt(meanI2/meanJ2)``,
  ``beta = meanI - alpha*meanJ`` where the means are FLT_SCALE-descaled
  (lucas_kanade_tracker.cc:366-367). Note the reference subtracts this
  descaled beta from raw-unit intensities, making the bias term numerically
  negligible; we reproduce that exactly rather than "fixing" it, since the
  SSIM gate and convergence behavior were tuned with it.
- Combined gradient ``d = dI + alpha*dJ`` (inverse-additive averaging).
- Flow update ``delta = (A12*b2 - A22*b1, A12*b1 - A11*b2)/det`` = -A^-1 b.
- Min-eigenvalue check divided by ``2*win_area`` (:413-426), drift clamp at
  10 px from the per-level start (:444-450), epsilon convergence on
  ``|delta|^2``, oscillation back-off of half a step (:452-459).
- Final SSIM outlier gate on /32 windows with C1=(0.01*255)^2,
  C2=(0.03*255)^2 (:469-592).

Status codes follow utilities/landmark_status.h:23.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

from functools import partial

import jax
import jax.numpy as jnp

from nrslam.ops import image as image_ops
from nrslam.utils.precision import highest_precision

# LandmarkStatus codes (landmark_status.h:23-30).
TRACKED_WITH_3D = 0
TRACKED = 1
JUST_TRIANGULATED = 2
BAD = 3
OUT_IMAGE_BOUNDARIES = 4
BAD_FEATURE = 5

FLT_SCALE = 1.0 / (1 << 20)
IVAL_SCALE = 32.0  # intensity stored as 32x gray, see module docstring


def is_usable(status: jnp.ndarray) -> jnp.ndarray:
    """IsUsable (landmark_status.cc:21-23): tracked-with-3d/tracked/just-triangulated."""
    return status <= JUST_TRIANGULATED


class KLTConfig(NamedTuple):
    win: int = 21
    max_level: int = 4        # pyramid has max_level+1 levels
    max_iters: int = 10
    epsilon: float = 1e-4
    min_eig_threshold: float = 1e-4


class KLTRefs(NamedTuple):
    """Per-point precomputed reference data ("photometric information").

    The reference exports this per point as PhotometricInformation
    (lucas_kanade_tracker.h:29-34) so landmarks can carry their patches
    across keyframe switches; here the arrays themselves are the store.
    """

    points: jnp.ndarray      # [P, 2] reference pixel positions
    patch: jnp.ndarray       # [P, L, W, W] intensity windows (ival units)
    patch_grad: jnp.ndarray  # [P, L, W, W, 2] Scharr gradient windows
    mean_i: jnp.ndarray      # [P, L] descaled window means
    mean_i2: jnp.ndarray     # [P, L] descaled window squared means
    valid: jnp.ndarray       # [P, L] window fully inside image + unmasked

    def level_slice(self, n_levels: int) -> "KLTRefs":
        """First ``n_levels`` pyramid levels of every per-level field.

        Explicit by field name: level-indexed arrays carry L on axis 1, but
        selecting them by shape coincidence would silently slice any future
        field whose dim-1 happens to equal L."""
        return self._replace(
            patch=self.patch[:, :n_levels],
            patch_grad=self.patch_grad[:, :n_levels],
            mean_i=self.mean_i[:, :n_levels],
            mean_i2=self.mean_i2[:, :n_levels],
            valid=self.valid[:, :n_levels])


@partial(jax.jit, static_argnames=("config",))
@highest_precision
def build_pyramid(img: jnp.ndarray, config: KLTConfig):
    """Image pyramid with Scharr derivative images, level 0 first."""
    return image_ops.build_pyramid(img, config.max_level + 1)


# ---------------------------------------------------------------------------
# Window extraction as one-hot matmuls.
#
# All patch sampling is phrased as one-hot row/column selection matmuls
# instead of gathers: selecting S rows of an [H, W] image is
# `one_hot(rows) @ img` — a [P*S, H] x [H, W] matmul. Every product has a
# single nonzero term, so the result equals direct indexing exactly when the
# matmul runs at full f32 precision (the frame programs pin it).
# ---------------------------------------------------------------------------

def _extract_patches(img: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray,
                     size: int) -> jnp.ndarray:
    """Integer-aligned [P, size, size(, C)] patches via one-hot matmuls.

    Out-of-image rows/cols clamp to the border (callers gate border points
    via the status logic, so clamped values are never load-bearing).
    """
    H, W = img.shape[0], img.shape[1]
    rows = jnp.clip(y0[:, None] + jnp.arange(size), 0, H - 1)
    cols = jnp.clip(x0[:, None] + jnp.arange(size), 0, W - 1)
    R = jax.nn.one_hot(rows, H, dtype=jnp.float32)       # [P, S, H]
    C = jax.nn.one_hot(cols, W, dtype=jnp.float32)       # [P, S, W]
    if img.ndim == 2:
        rowsel = jnp.einsum("psh,hw->psw", R, img)
        return jnp.einsum("psw,ptw->pst", rowsel, C)
    rowsel = jnp.einsum("psh,hwc->pswc", R, img)
    return jnp.einsum("pswc,ptw->pstc", rowsel, C)


def _tile_window(tiles_t: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray,
                 size: int) -> jnp.ndarray:
    """Extract [P, size, size(, C)] windows at integer offsets from
    POINT-LAST tiles [T, T(, C), P] (see :func:`_tiles_point_last`).

    The offsets are bounded by the tile margin (T - size + 1 possible
    shifts, 27 for the production 48-tile / 22-window), so the window is a
    masked sum over shifted slices. The layout is the point: with P on the
    lane axis, both shift dimensions are un-tiled leading axes, so every
    slice is a free view and the selects vectorize across points — vs a
    [P, T, T] layout where the same slices hit the minor dims and each shift
    forces a relayout of the whole tile stack.
    Called once per KLT iteration — the tracker's inner-loop hot op."""
    n_shift = tiles_t.shape[0] - size + 1

    def shift_select(x, off, axis):
        acc = None
        for k in range(n_shift):
            sl = jax.lax.slice_in_dim(x, k, k + size, axis=axis)
            term = jnp.where(off == k, sl, 0.0)   # off [P] rides lanes
            acc = term if acc is None else acc + term
        return acc

    win = shift_select(shift_select(tiles_t, dy, 0), dx, 1)
    # Back to the [P, size, size(, C)] layout the window math uses.
    if win.ndim == 3:
        return jnp.transpose(win, (2, 0, 1))
    return jnp.transpose(win, (3, 0, 1, 2))


def _tiles_point_last(tiles: jnp.ndarray) -> jnp.ndarray:
    """[P, T, T(, C)] -> [T, T(, C), P] (done once per level, outside the
    iteration loop, so _tile_window's slices stay layout-free)."""
    if tiles.ndim == 3:
        return jnp.transpose(tiles, (1, 2, 0))
    return jnp.transpose(tiles, (1, 2, 3, 0))


def _bilinear_from_int(win_plus1: jnp.ndarray, fx: jnp.ndarray,
                       fy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation of a (S+1)-sized integer window down to S,
    with one scalar fractional weight pair per point."""
    w00 = ((1 - fx) * (1 - fy))
    w01 = (fx * (1 - fy))
    w10 = ((1 - fx) * fy)
    w11 = (fx * fy)
    if win_plus1.ndim == 3:
        w00 = w00[:, None, None]
        w01 = w01[:, None, None]
        w10 = w10[:, None, None]
        w11 = w11[:, None, None]
    else:
        w00 = w00[:, None, None, None]
        w01 = w01[:, None, None, None]
        w10 = w10[:, None, None, None]
        w11 = w11[:, None, None, None]
    return (w00 * win_plus1[:, :-1, :-1] + w01 * win_plus1[:, :-1, 1:]
            + w10 * win_plus1[:, 1:, :-1] + w11 * win_plus1[:, 1:, 1:])


def _sample_image_windows(img, pts, win: int):
    """Bilinear window centered at continuous pts: [P, win, win(, C)]."""
    half = (win - 1) * 0.5
    base_x = jnp.floor(pts[:, 0] - half)
    base_y = jnp.floor(pts[:, 1] - half)
    fx = pts[:, 0] - half - base_x
    fy = pts[:, 1] - half - base_y
    iw = _extract_patches(img, base_y.astype(jnp.int32),
                          base_x.astype(jnp.int32), win + 1)
    return _bilinear_from_int(iw, fx, fy)


def _sample_windows(img, grad, pts, win: int):
    """Bilinear intensity + gradient windows centered at continuous pts."""
    return (_sample_image_windows(img, pts, win),
            _sample_image_windows(grad, pts, win))


@partial(jax.jit, static_argnames=("config",))
@highest_precision
def set_reference(pyramid, points: jnp.ndarray, point_valid: jnp.ndarray,
                  config: KLTConfig, mask: jnp.ndarray | None = None) -> KLTRefs:
    """Precompute per-point per-level reference windows.

    Mirrors LucasKanadeTracker::SetReferenceImage
    (lucas_kanade_tracker.cc:47-168). A level is invalid for a point when the
    window leaves the image (border gap = win//2) or touches a masked pixel.

    Args:
      pyramid: list of (img, grad) from :func:`build_pyramid`.
      points: [P, 2] full-resolution pixel positions.
      point_valid: [P] bool slots actually occupied.
      mask: optional [H, W] bool validity mask at full resolution.
    """
    win = config.win
    n_levels = len(pyramid)
    border_gap = round(win / 2)

    mask_pyramid = []
    if mask is not None:
        m = mask.astype(jnp.float32)
        for _ in range(n_levels):
            mask_pyramid.append(m)
            h2, w2 = m.shape[0] // 2, m.shape[1] // 2
            m = jnp.minimum(
                jnp.minimum(m[0:2 * h2:2, 0:2 * w2:2], m[1:2 * h2:2, 0:2 * w2:2]),
                jnp.minimum(m[0:2 * h2:2, 1:2 * w2:2], m[1:2 * h2:2, 1:2 * w2:2]))

    patches, grads, means, means2, valids = [], [], [], [], []
    for level, (img, grad) in enumerate(pyramid):
        scale = 1.0 / (1 << level)
        pts_l = points * scale

        iw, gw = _sample_windows(img, grad, pts_l, win)
        iw = iw * IVAL_SCALE

        h, w = img.shape
        # In-bounds test matching the floor(point - halfWin) convention.
        ip = jnp.floor(pts_l - (win - 1) * 0.5)
        in_bounds = ((ip[:, 0] >= -border_gap) & (ip[:, 0] < w - border_gap)
                     & (ip[:, 1] >= -border_gap) & (ip[:, 1] < h - border_gap))
        ok = in_bounds & point_valid
        if mask is not None:
            # Window pixels map back to full res by * 2^level
            # (lucas_kanade_tracker.cc:118-122). A min-pooled mask pyramid
            # level is equivalent to checking every covered full-res pixel.
            mw = _extract_patches(
                mask_pyramid[level],
                jnp.floor(pts_l[:, 1] - (win - 1) * 0.5).astype(jnp.int32),
                jnp.floor(pts_l[:, 0] - (win - 1) * 0.5).astype(jnp.int32),
                win + 1)
            ok = ok & (jnp.min(mw.reshape(mw.shape[0], -1), axis=-1) > 0.99)

        sum_i = jnp.sum(iw, axis=(-2, -1))
        sum_i2 = jnp.sum(iw * iw, axis=(-2, -1))
        area = win * win
        means.append(sum_i * FLT_SCALE / area)
        means2.append(sum_i2 * FLT_SCALE / area)
        patches.append(iw)
        grads.append(gw)
        valids.append(ok)

    return KLTRefs(
        points=points,
        patch=jnp.stack(patches, axis=1),
        patch_grad=jnp.stack(grads, axis=1),
        mean_i=jnp.stack(means, axis=1),
        mean_i2=jnp.stack(means2, axis=1),
        valid=jnp.stack(valids, axis=1),
    )


def _ssim_gate(img0, refs: KLTRefs, pts, statuses, min_ssim, config: KLTConfig,
               mask=None):
    """Final SSIM outlier check vs the level-0 reference window (:469-592)."""
    win = config.win
    h, w = img0.shape
    border_gap = round(win / 2) + 1

    jw = _sample_image_windows(img0, pts, win) * IVAL_SCALE

    ip = jnp.floor(pts - (win - 1) * 0.5)
    in_bounds = ((ip[:, 0] >= -border_gap) & (ip[:, 0] < w - border_gap * 2)
                 & (ip[:, 1] >= -border_gap) & (ip[:, 1] < h - border_gap * 2))

    # /32 descaling used by the reference before SSIM (integer division there;
    # float here — SSIM is scale-tolerant enough at this magnitude).
    cur = jw / 32.0
    ref = refs.patch[:, 0] / 32.0

    n = win * win
    n_inv = 1.0 / n
    n_inv_1 = 1.0 / (n - 1)
    mu_x = jnp.sum(ref, axis=(-2, -1)) * n_inv
    mu_y = jnp.sum(cur, axis=(-2, -1)) * n_inv
    xn = ref - mu_x[:, None, None]
    yn = cur - mu_y[:, None, None]
    sx2 = jnp.sum(xn * xn, axis=(-2, -1)) * n_inv_1
    sy2 = jnp.sum(yn * yn, axis=(-2, -1)) * n_inv_1
    sxy = jnp.sum(xn * yn, axis=(-2, -1)) * n_inv_1

    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    ssim = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (sx2 + sy2 + c2))

    usable = is_usable(statuses)
    nan_pt = jnp.any(jnp.isnan(pts), axis=-1)
    statuses = jnp.where(usable & (nan_pt | ~in_bounds),
                         OUT_IMAGE_BOUNDARIES, statuses)
    usable = is_usable(statuses)
    statuses = jnp.where(usable & (ssim < min_ssim), BAD_FEATURE, statuses)
    return statuses, ssim


def track(pyramid, refs: KLTRefs, seeds: jnp.ndarray, statuses: jnp.ndarray,
          config: KLTConfig, min_ssim: float, use_initial_flow: bool = True,
          mask: jnp.ndarray | None = None):
    """Track all points into a new pyramid.

    Functional equivalent of LucasKanadeTracker::Track
    (lucas_kanade_tracker.cc:170-596). Returns (points [P, 2], statuses [P]).
    Points whose reference data is invalid at level 0 come back
    OUT_IMAGE_BOUNDARIES, as in the reference (`!IWinBuf.ptr` check :246-252).
    """
    win = config.win
    max_level = len(pyramid) - 1
    area = win * win
    eps = config.epsilon

    pts = jnp.where(
        use_initial_flow, seeds, jnp.broadcast_to(refs.points, seeds.shape))
    pts = pts / (1 << max_level)

    for level in range(max_level, -1, -1):
        img, grad = pyramid[level]
        h, w = img.shape
        border_gap = round(win / 2) + 1
        prev_pts_l = refs.points / (1 << level)

        ref_patch = refs.patch[:, level]
        ref_grad = refs.patch_grad[:, level]
        mean_i = refs.mean_i[:, level]
        mean_i2 = refs.mean_i2[:, level]
        ref_ok = refs.valid[:, level]

        # Previous-point bounds check (applies OUT at level 0: :227-239).
        ipp = jnp.floor(prev_pts_l - (win - 1) * 0.5)
        prev_in = ((ipp[:, 0] >= -border_gap) & (ipp[:, 0] < w - border_gap)
                   & (ipp[:, 1] >= -border_gap) & (ipp[:, 1] < h - border_gap))
        track_this_level = is_usable(statuses) & prev_in & ref_ok
        if level == 0:
            statuses = jnp.where(
                is_usable(statuses) & ~(prev_in & ref_ok),
                OUT_IMAGE_BOUNDARIES, statuses)

        start = pts  # per-level start coordinates (drift clamp anchor)

        # Per-point image tiles covering the whole iteration range: the drift
        # clamp bounds every sampled position to <= 10 px from the level
        # start, so a 48-tile (22 window + 2*13 margin) holds all windows.
        TILE = 48
        margin = (TILE - (win + 1)) // 2
        half = (win - 1) * 0.5
        tile_x0 = jnp.floor(start[:, 0] - half).astype(jnp.int32) - margin
        tile_y0 = jnp.floor(start[:, 1] - half).astype(jnp.int32) - margin
        # Point-last layout once per level; the per-iteration window
        # extraction then slices un-tiled leading axes (see _tile_window).
        timg = _tiles_point_last(_extract_patches(img, tile_y0, tile_x0, TILE))
        tgrad = _tiles_point_last(_extract_patches(grad, tile_y0, tile_x0,
                                                   TILE))

        def iter_cond(carry):
            # Early exit once every point has converged/failed: identical
            # results (updates are masked by `done` anyway), far fewer serial
            # device iterations in the common case.
            j, pts, prev_delta, done, statuses = carry
            return (j < config.max_iters) & ~jnp.all(done)

        def iter_body(carry):
            j, pts, prev_delta, done, statuses = carry
            active = track_this_level & ~done

            base_x = jnp.floor(pts[:, 0] - half)
            base_y = jnp.floor(pts[:, 1] - half)
            fx = pts[:, 0] - half - base_x
            fy = pts[:, 1] - half - base_y
            dx_t = jnp.clip(base_x.astype(jnp.int32) - tile_x0, 0, TILE - win - 1)
            dy_t = jnp.clip(base_y.astype(jnp.int32) - tile_y0, 0, TILE - win - 1)
            jw = _bilinear_from_int(
                _tile_window(timg, dy_t, dx_t, win + 1), fx, fy) * IVAL_SCALE
            gw = _bilinear_from_int(
                _tile_window(tgrad, dy_t, dx_t, win + 1), fx, fy)

            # Current-point bounds check.
            ipt = jnp.floor(pts - (win - 1) * 0.5)
            cur_in = ((ipt[:, 0] >= -border_gap) & (ipt[:, 0] < w - border_gap)
                      & (ipt[:, 1] >= -border_gap) & (ipt[:, 1] < h - border_gap))
            oob = active & ~cur_in
            if level == 0:
                statuses = jnp.where(oob, OUT_IMAGE_BOUNDARIES, statuses)
            done = done | oob
            active = active & ~oob

            mean_j = jnp.sum(jw, axis=(-2, -1)) * FLT_SCALE / area
            mean_j2 = jnp.sum(jw * jw, axis=(-2, -1)) * FLT_SCALE / area
            alpha = jnp.sqrt(mean_i2 / jnp.maximum(mean_j2, 1e-20))
            beta = mean_i - alpha * mean_j

            diff = jw * alpha[:, None, None] - ref_patch - beta[:, None, None]
            d = ref_grad + gw * alpha[:, None, None, None]
            dx, dy = d[..., 0], d[..., 1]

            b1 = jnp.sum(diff * dx, axis=(-2, -1)) * FLT_SCALE
            b2 = jnp.sum(diff * dy, axis=(-2, -1)) * FLT_SCALE
            a11 = jnp.sum(dx * dx, axis=(-2, -1)) * FLT_SCALE
            a12 = jnp.sum(dx * dy, axis=(-2, -1)) * FLT_SCALE
            a22 = jnp.sum(dy * dy, axis=(-2, -1)) * FLT_SCALE

            det = a11 * a22 - a12 * a12
            min_eig = (a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) / (2.0 * area)
            degenerate = active & ((min_eig < config.min_eig_threshold)
                                   | (det < jnp.finfo(jnp.float32).tiny))
            if level == 0:
                statuses = jnp.where(degenerate, BAD_FEATURE, statuses)
            # The reference `continue`s (retries next iter) on degeneracy; with
            # an unchanged point that loops forever doing nothing, so masking
            # the update is equivalent.
            solve = active & ~degenerate

            safe_det = jnp.where(jnp.abs(det) > 0, det, 1.0)
            delta = jnp.stack([(a12 * b2 - a22 * b1) / safe_det,
                               (a12 * b1 - a11 * b2) / safe_det], axis=-1)
            delta = jnp.where(solve[:, None], delta, 0.0)

            new_pts = pts + delta

            # Post-update border check on the +halfWin coordinates (:437-443).
            ppix = new_pts  # window center == keypoint position
            out_post = solve & ((ppix[:, 0] < border_gap + 1) | (ppix[:, 0] >= w - 1 - border_gap)
                                | (ppix[:, 1] < border_gap + 1) | (ppix[:, 1] >= h - 1 - border_gap))
            if level == 0:
                statuses = jnp.where(out_post, OUT_IMAGE_BOUNDARIES, statuses)

            # Drift clamp: >10 px from the per-level start resets the point
            # (:444-450). The reference checks bounds -> drift -> convergence
            # -> oscillation, each breaking, so later checks only apply when
            # earlier ones did not fire.
            drift = jnp.linalg.norm(new_pts - start, axis=-1)
            drifted = solve & ~out_post & (drift > 10.0)
            if level == 0:
                statuses = jnp.where(drifted, BAD, statuses)
            new_pts = jnp.where(drifted[:, None], start, new_pts)

            live = solve & ~out_post & ~drifted
            converged = live & (jnp.sum(delta * delta, axis=-1) <= eps)
            oscillating = live & (j > 0) \
                & (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01) \
                & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
            new_pts = jnp.where((oscillating & ~converged)[:, None],
                                new_pts - delta * 0.5, new_pts)

            done = done | out_post | drifted | converged | oscillating
            pts = jnp.where(solve[:, None], new_pts, pts)
            return j + 1, pts, delta, done, statuses

        init = (jnp.int32(0), pts, jnp.zeros_like(pts), ~track_this_level,
                statuses)
        _, pts, _, _, statuses = jax.lax.while_loop(iter_cond, iter_body, init)

        if level > 0:
            pts = pts * 2.0

    statuses, _ = _ssim_gate(pyramid[0][0], refs, pts, statuses, min_ssim,
                             config, mask)
    return pts, statuses
