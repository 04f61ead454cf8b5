"""Trajectory metrics: ATE (absolute trajectory error) with Sim(3)/SE(3)
alignment.

The reference computes only per-frame depth RMSE (frame_evaluator.cc); the
papers report ATE, so the framework provides it: Umeyama alignment of the
estimated camera-center trajectory against ground truth (with optional scale
for monocular), then RMSE of the residual translations.
"""

from __future__ import annotations

import numpy as np


def camera_centers(poses_tcw) -> np.ndarray:
    """Tcw list -> camera centers in world frame [N, 3]."""
    from nrslam.geometry import se3
    centers = []
    for T in poses_tcw:
        centers.append(np.asarray(se3.inverse(T).t))
    return np.stack(centers)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses, gt_poses, with_scale: bool = True) -> float:
    """Absolute trajectory error after Umeyama alignment."""
    est = camera_centers(est_poses)
    gt = camera_centers(gt_poses)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    s, R, t = umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_trans_rmse(est_poses, gt_poses, delta: int = 5,
                   with_scale: bool = True) -> float:
    """Relative pose error (translation): RMSE of the error of delta-frame
    relative displacements after one global Sim(3)/SE(3) alignment.

    The drift-robust companion to ATE for long sequences: accumulated drift
    (which any odometry without loop closure exhibits) inflates ATE
    linearly with trajectory length, while RPE stays a per-step local
    accuracy measure — the SLAM papers' standard pairing.
    """
    est = camera_centers(est_poses)
    gt = camera_centers(gt_poses)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    s, R, t = umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    d_est = aligned[delta:] - aligned[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))
