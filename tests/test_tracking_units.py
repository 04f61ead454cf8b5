"""Unit tests for tracking/mapping internals (beyond the e2e flows)."""

import jax
import jax.numpy as jnp
import numpy as np

from nrslam.datasets import synthetic
from nrslam.geometry import cameras, se3
from nrslam.ops import klt
from nrslam.slam import graph as graph_mod
from nrslam.slam import mapping as mapping_mod
from nrslam.slam import state as state_mod
from nrslam.slam import tracking as tracking_mod
from nrslam.slam.state import Config


SCENE = synthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
CAM = synthetic.camera(SCENE)
CFG = Config(max_points=64, max_keyframes=4, temporal_window=6,
             klt_levels=3, klt_win=11, max_new_keypoints=16,
             rad_per_pixel=0.01)


def tracking_state(n=48, seed=0):
    gray, depth, _ = synthetic.render_frame(0, SCENE)
    pyr = klt.build_pyramid(gray, CFG.klt_config)
    state = state_mod.empty_state(CFG, gray.shape)
    key = jax.random.PRNGKey(seed)
    uv = jnp.stack([
        15 + 98 * jax.random.uniform(key, (CFG.max_points,)),
        15 + 66 * jax.random.uniform(jax.random.fold_in(key, 1), (CFG.max_points,)),
    ], -1)
    from nrslam.ops import image as image_ops
    d = image_ops.bilinear_sample(depth, uv)
    X = cameras.unproject(CAM, uv) * d[:, None]
    used = jnp.arange(CFG.max_points) < n
    refs = klt.set_reference(pyr, uv, used, CFG.klt_config)
    state = state._replace(
        slot_used=used, track_id=jnp.arange(CFG.max_points, dtype=jnp.int32),
        has_3d=used, positions=jnp.where(used[:, None], X, 0.0),
        keypoints=uv, refs=refs,
        status=jnp.where(used, klt.TRACKED_WITH_3D,
                         state_mod.NOT_IN_FRAME).astype(jnp.int32),
        graph=graph_mod.initialize(state.graph, X, used, 3.0),
        next_track_id=jnp.int32(CFG.max_points))
    state = state_mod.insert_keyframe(state)
    state = state_mod.insert_temporal_snapshot(state)
    return state, pyr, gray


def test_update_triangulated_promotes():
    state, _, _ = tracking_state()
    state = state._replace(status=state.status.at[0].set(klt.JUST_TRIANGULATED))
    out = tracking_mod.update_triangulated_points(state)
    assert int(out.status[0]) == klt.TRACKED_WITH_3D


def test_point_reuse_reacquires_lost_point():
    state, pyr, _ = tracking_state()
    # Mark point 0 lost (KLT failure) but keep its 3D + stored patches.
    lost_state = state._replace(status=state.status.at[0].set(klt.BAD_FEATURE))
    out = tracking_mod.point_reuse(lost_state, pyr, CAM, CFG,
                                   jnp.zeros(CFG.max_points, bool))
    # Same frame as the reference image: projection == original keypoint,
    # the 2-level KLT re-locks onto it.
    assert int(out.status[0]) == klt.TRACKED_WITH_3D
    np.testing.assert_allclose(np.asarray(out.keypoints[0]),
                               np.asarray(state.keypoints[0]), atol=1.0)


def test_point_reuse_ignores_behind_camera():
    state, pyr, _ = tracking_state()
    behind = state.positions.at[1].set(jnp.array([0.0, 0.0, -5.0]))
    lost_state = state._replace(
        positions=behind,
        status=state.status.at[1].set(klt.BAD_FEATURE))
    out = tracking_mod.point_reuse(lost_state, pyr, CAM, CFG,
                                   jnp.zeros(CFG.max_points, bool))
    assert int(out.status[1]) == klt.BAD_FEATURE


def test_create_keyframe_allocates_and_recycles():
    state, pyr, gray = tracking_state(n=40)
    # Kill a non-3D feature slot -> should be recycled.
    state = state._replace(
        has_3d=state.has_3d.at[5].set(False),
        status=state.status.at[5].set(klt.BAD))
    mask = jnp.ones(gray.shape, bool)
    out = tracking_mod.create_keyframe(state, pyr, mask, CFG)
    # New keyframe recorded.
    assert int(jnp.sum(out.kf_valid)) == int(jnp.sum(state.kf_valid)) + 1
    # New features got fresh track ids.
    assert int(out.next_track_id) > int(state.next_track_id)
    # The dead slot is either recycled (new feature, new id) or freed.
    recycled = bool(out.slot_used[5]) and int(out.track_id[5]) != 5
    freed = not bool(out.slot_used[5])
    assert recycled or freed


def test_temporal_snapshot_ring():
    state, _, _ = tracking_state()
    fid0 = int(state.frame_id)
    for _ in range(CFG.temporal_window + 2):
        state = state_mod.insert_temporal_snapshot(state)
    assert int(state.frame_id) == fid0 + CFG.temporal_window + 2
    assert bool(jnp.all(state.tb_valid))
    # Ring holds the last T frame ids.
    ids = np.sort(np.asarray(state.tb_frame_id))
    expected = np.arange(fid0 + 2, fid0 + 2 + CFG.temporal_window)
    np.testing.assert_array_equal(ids, expected)


def test_closest_mapped_neighbors_gates():
    state, _, _ = tracking_state()
    nbr_idx, nbr_valid, cand_ok = mapping_mod._closest_mapped_neighbors(state, CFG)
    # Points in a random cloud: some candidates disqualified by the
    # min-distance rule, but valid ones have sorted nearest neighbors.
    i = int(np.argmax(np.asarray(cand_ok)))
    if bool(cand_ok[i]):
        kps = np.asarray(state.tb_keypoints[0])
        d = np.linalg.norm(kps[np.asarray(nbr_idx[i])] - kps[i], axis=-1)
        v = np.asarray(nbr_valid[i])
        assert (d[v] >= CFG.tri_min_neighbors_px - 1e-3).all()
        assert (d[v] <= CFG.tri_max_neighbors_px + 1e-3).all()
