"""Headless visualization dumps: feature overlays, graph renders, PLY export.

Replaces the reference's interactive OpenCV/Pangolin visualizers
(modules/visualization/) with file outputs usable in headless jobs:

- ``draw_frame``: current-frame features colored by status
  (ImageVisualizer::DrawCurrentFrame, image_visualizer.cc:58-105).
- ``draw_graph``: regularization-graph edges colored by weight
  (DrawRegularizationGraph, image_visualizer.cc:120+).
- ``export_ply``: map landmarks + keyframe trajectory as a PLY point cloud
  (the MapVisualizer's content, map_visualizer.cc:150-220, minus OpenGL).
- ``unique_colors``: the ColorFactory palette (color_factory.cc).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Fixed distinct-color palette (ColorFactory::GetUniqueColors analogue).
_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], np.uint8)

STATUS_COLORS = {
    0: (0, 255, 0),     # TRACKED_WITH_3D: green
    1: (255, 255, 0),   # TRACKED: yellow
    2: (0, 255, 255),   # JUST_TRIANGULATED: cyan
}


def unique_colors(n: int) -> np.ndarray:
    reps = int(np.ceil(n / len(_PALETTE)))
    return np.tile(_PALETTE, (reps, 1))[:n]


def _to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _disk(img, x, y, color, r=2):
    h, w, _ = img.shape
    x, y = int(round(x)), int(round(y))
    y0, y1 = max(0, y - r), min(h, y + r + 1)
    x0, x1 = max(0, x - r), min(w, x + r + 1)
    img[y0:y1, x0:x1] = color
    return img


def draw_frame(gray, keypoints, statuses, slot_used) -> np.ndarray:
    """Feature overlay colored by status; returns RGB uint8."""
    img = _to_rgb(gray)
    kps = np.asarray(keypoints)
    sts = np.asarray(statuses)
    used = np.asarray(slot_used)
    for i in range(len(kps)):
        if used[i] and int(sts[i]) in STATUS_COLORS:
            _disk(img, kps[i, 0], kps[i, 1], STATUS_COLORS[int(sts[i])])
    return img


def draw_graph(gray, keypoints, statuses, slot_used, graph, max_edges=500) -> np.ndarray:
    """Edges between tracked keypoints, brightness ~ weight."""
    img = _to_rgb(gray)
    kps = np.asarray(keypoints)
    ok = np.asarray(slot_used) & (np.asarray(statuses) == 0)
    w = np.asarray(graph.weight)
    exists = np.asarray(graph.exists & ~graph.bad)
    idx = np.argwhere(np.triu(exists) & ok[:, None] & ok[None, :])
    if len(idx) > max_edges:
        order = np.argsort(-w[idx[:, 0], idx[:, 1]])[:max_edges]
        idx = idx[order]
    for i, j in idx:
        _line(img, kps[i], kps[j],
              np.array([0, int(255 * min(w[i, j], 1.0)), 0], np.uint8))
    for i in np.nonzero(ok)[0]:
        _disk(img, kps[i, 0], kps[i, 1], (0, 255, 0))
    return img


def _line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    h, w, _ = img.shape
    for t in np.linspace(0, 1, min(n, 200)):
        x = int(round(p0[0] + t * (p1[0] - p0[0])))
        y = int(round(p0[1] + t * (p1[1] - p0[1])))
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
    return img


def draw_optical_flow(gray, state) -> np.ndarray:
    """Per-track 2D flow trails from the temporal buffer.

    ImageVisualizer::DrawOpticalFlow (image_visualizer.cc:117-150): for each
    live track, a polyline through its keypoint positions over the buffered
    snapshots — blue for TRACKED, green for TRACKED_WITH_3D. Slots are stable
    across snapshots here, so track identity is the slot index.
    """
    img = _to_rgb(gray)
    tb_valid = np.asarray(state.tb_valid)
    frame_ids = np.asarray(state.tb_frame_id)
    kps = np.asarray(state.tb_keypoints)      # [T, P, 2]
    tracked = np.asarray(state.tb_tracked)    # [T, P]
    with3d = np.asarray(state.tb_with3d)
    order = np.argsort(frame_ids)
    order = [t for t in order if tb_valid[t]]
    if not order:
        return img
    last = order[-1]
    P = kps.shape[1]
    for p in range(P):
        if not tracked[last, p]:
            continue
        color = (0, 255, 0) if with3d[last, p] else (0, 0, 255)
        prev = kps[last, p]
        for t in reversed(order[:-1]):
            if not tracked[t, p]:
                break
            _line(img, prev, kps[t, p], np.array(color, np.uint8))
            prev = kps[t, p]
    return img


def cluster_flow_tracks(ref_keypoints, cur_keypoints, valid) -> np.ndarray:
    """DBSCAN-ND labels over feature-flow vectors (the initializer's
    FeatureTracksClustering, monocular_map_initializer.cc:185-219; cluster
    labels feed DrawClusteredOpticalFlow). Returns [F] int labels (-1 noise
    or invalid)."""
    import jax.numpy as jnp

    from nrslam.ops import dbscan
    flow = jnp.asarray(cur_keypoints) - jnp.asarray(ref_keypoints)
    labels = dbscan.dbscan_nd(flow, jnp.asarray(valid))
    labels = np.array(labels)  # writable copy
    labels[~np.asarray(valid)] = -1
    return labels


def draw_clustered_flow(gray, ref_keypoints, cur_keypoints, valid,
                        labels=None) -> np.ndarray:
    """Flow segments colored by cluster id
    (ImageVisualizer::DrawClusteredOpticalFlow, image_visualizer.cc:152-188;
    color = unique_colors[label + 1], noise label -1 -> color 0)."""
    if labels is None:
        labels = cluster_flow_tracks(ref_keypoints, cur_keypoints, valid)
    img = _to_rgb(gray)
    ref = np.asarray(ref_keypoints)
    cur = np.asarray(cur_keypoints)
    ok = np.asarray(valid)
    colors = unique_colors(int(np.max(labels, initial=0)) + 2)
    for i in np.nonzero(ok)[0]:
        _line(img, cur[i], ref[i], colors[int(labels[i]) + 1])
        _disk(img, cur[i, 0], cur[i, 1], colors[int(labels[i]) + 1], r=1)
    return img


def draw_essential_inliers(gray, keypoints, inlier, valid) -> np.ndarray:
    """Essential-matrix inlier overlay (the "Essential Matrix inliers"
    window, image_visualizer.cc:190-213): green = reconstructed inlier,
    red = rejected candidate."""
    img = _to_rgb(gray)
    kps = np.asarray(keypoints)
    inl = np.asarray(inlier)
    for i in np.nonzero(np.asarray(valid))[0]:
        _disk(img, kps[i, 0], kps[i, 1],
              (0, 255, 0) if inl[i] else (255, 0, 0))
    return img


def export_flow_trails_ply(path: str, state, max_history: int = 20) -> None:
    """Per-landmark 3D flow trails as a PLY line set.

    MapVisualizer::DrawLastFrame collects GetLandmarkFlow(20) per tracked
    landmark and renders line strips (map_visualizer.cc:166-199 +
    Draw3DFlow); here the position history comes from the temporal-buffer
    ring (tb_positions) and is written as PLY vertices + edge elements,
    loadable by standard viewers.
    """
    tb_valid = np.asarray(state.tb_valid)
    frame_ids = np.asarray(state.tb_frame_id)
    hist = np.asarray(state.tb_positions)     # [T, P, 3]
    with3d = np.asarray(state.tb_with3d)
    order = [t for t in np.argsort(frame_ids) if tb_valid[t]][-max_history:]
    cur_ok = np.asarray(state.slot_used & state.has_3d & (state.status == 0))

    verts = []
    edges = []
    for p in np.nonzero(cur_ok)[0]:
        trail = [t for t in order if with3d[t, p]]
        start = len(verts)
        for t in trail:
            verts.append(hist[t, p])
        for k in range(len(trail) - 1):
            edges.append((start + k, start + k + 1))
    verts = np.asarray(verts, np.float32).reshape(-1, 3)

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def save_png(path: str, img: np.ndarray) -> None:
    try:
        import cv2
        cv2.imwrite(str(path), np.asarray(img)[..., ::-1])
    except Exception:
        from PIL import Image
        Image.fromarray(np.asarray(img)).save(path)


def export_ply(path: str, state) -> None:
    """Landmarks (green) + keyframe camera centers (red) as PLY."""
    from nrslam.geometry import se3
    pts = []
    cols = []
    used = np.asarray(state.slot_used & state.has_3d)
    P = np.asarray(state.positions)[used]
    pts.append(P)
    cols.append(np.tile([0, 255, 0], (len(P), 1)))
    kf_ok = np.asarray(state.kf_valid)
    for i in np.nonzero(kf_ok)[0]:
        c = np.asarray(se3.inverse(se3.index(state.kf_pose, int(i))).t)
        pts.append(c[None])
        cols.append(np.array([[255, 0, 0]]))
    pts = np.concatenate(pts)
    cols = np.concatenate(cols).astype(np.uint8)

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
