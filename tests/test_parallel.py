"""Multi-device sharding tests on the virtual 8-CPU mesh.

Validates the distribution design of nrslam/parallel: state sharded over
the point axis runs the full pipeline steps unchanged (XLA SPMD inserts the
collectives) and produces the same numbers as single-device execution; the
hand-written shard_map pose system psums to the identical 6x6 normal
equations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nrslam.parallel import sharding as shard_mod


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return shard_mod.make_mesh(jax.devices()[:8])


def _problem(max_points=64):
    import __graft_entry__ as ge
    return ge._small_problem(max_points=max_points)


def test_sharded_tracking_matches_single_device(mesh):
    from nrslam.slam import tracking as tracking_mod

    state, pyr, cam, config, shape = _problem()
    mask = jnp.ones(shape, bool)

    ref_state, ref_res = tracking_mod._process_frame_impl(
        state, pyr, mask, cam.params, cam.kind, config, make_keyframe=False)

    sstate = shard_mod.shard_state(state, mesh, config.max_points)
    spyr = shard_mod.replicate(pyr, mesh)
    smask = shard_mod.replicate(mask, mesh)
    out_state, out_res = tracking_mod._process_frame_impl(
        sstate, spyr, smask, cam.params, cam.kind, config, make_keyframe=False)

    assert int(out_res.n_tracked_3d) == int(ref_res.n_tracked_3d)
    np.testing.assert_allclose(np.asarray(out_state.Tcw.t),
                               np.asarray(ref_state.Tcw.t), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_state.positions),
                               np.asarray(ref_state.positions), atol=1e-3)


def test_shard_map_pose_system_matches(mesh):
    from nrslam.solver import residuals, core
    from nrslam.geometry import se3

    state, pyr, cam, config, shape = _problem()
    w = state.slot_used.astype(jnp.float32)

    psys = shard_mod.pose_system_shard_map(mesh, cam)
    H, g = psys(state.Tcw.q, state.Tcw.t,
                jax.device_put(state.positions, NamedSharding(mesh, P("pt"))),
                jax.device_put(state.keypoints, NamedSharding(mesh, P("pt"))),
                jax.device_put(w, NamedSharding(mesh, P("pt"))))

    e, J, _ = residuals.reprojection(cam, state.Tcw, state.positions,
                                     state.keypoints)
    chi2 = jnp.sum(e * e, axis=-1)
    wh = core.huber_weight(chi2, 5.99) * w
    H_ref = jnp.einsum("pri,p,prj->ij", J, wh, J)
    g_ref = jnp.einsum("pri,p,pr->i", J, wh, e)
    # Tolerances account for cross-device reduction-order differences
    # (psum over shards vs one einsum); H entries span ~1e6.
    scale = np.abs(np.asarray(H_ref)).max()
    np.testing.assert_allclose(np.asarray(H), np.asarray(H_ref),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               atol=1e-5 * max(1.0, np.abs(np.asarray(g_ref)).max()))


def test_kf_sharded_ba_matches_single_device():
    """Keyframe-axis BA with ppermute halo == single-device BA."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from tests.test_bundle_adjustment import make_window, CAM
    from nrslam.geometry import se3
    from nrslam.parallel import ba_shard
    from nrslam.solver import bundle_adjustment as ba

    poses_true, L_true, obs, problem = make_window(K=8, P=64)
    key = jax.random.PRNGKey(7)
    poses0 = se3.SE3(poses_true.q,
                     poses_true.t + 0.01 * jax.random.normal(
                         key, poses_true.t.shape))
    L0 = L_true + 0.03 * jax.random.normal(jax.random.fold_in(key, 1),
                                           L_true.shape)

    poses_ref, L_ref = ba.local_deformable_ba(CAM, poses0, L0, problem)

    kf_mesh = Mesh(np.array(jax.devices()[:4]), ("kf",))
    poses_sh, L_sh = ba_shard.local_deformable_ba_kf_sharded(
        kf_mesh, CAM, poses0, L0, problem)

    np.testing.assert_allclose(np.asarray(poses_sh.t),
                               np.asarray(poses_ref.t), atol=2e-4)
    np.testing.assert_allclose(np.asarray(L_sh), np.asarray(L_ref), atol=2e-3)

    # and it actually solved the problem, not just matched:
    from nrslam.geometry import cameras
    pred = cameras.project(CAM, se3.apply(
        jax.tree.map(lambda x: x[:, None], poses_sh), L_sh))
    rmse = float(jnp.sqrt(jnp.mean(jnp.sum((pred - obs) ** 2, -1))))
    pred0 = cameras.project(CAM, se3.apply(
        jax.tree.map(lambda x: x[:, None], poses0), L0))
    rmse0 = float(jnp.sqrt(jnp.mean(jnp.sum((pred0 - obs) ** 2, -1))))
    assert rmse < 0.2 * rmse0, (rmse0, rmse)


def test_kf_sharded_ba_masked_keyframes():
    """Invalid keyframe slots (ring not yet full) stay inert when sharded."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from tests.test_bundle_adjustment import make_window, CAM
    from nrslam.parallel import ba_shard

    poses_true, L_true, obs, problem = make_window(K=8, P=64)
    kf_valid = jnp.arange(8) < 5
    problem = problem._replace(
        kf_valid=kf_valid,
        obs=jnp.where(kf_valid[:, None, None], problem.obs, jnp.nan))
    L0 = jnp.where(kf_valid[:, None, None], L_true, 1.0)
    kf_mesh = Mesh(np.array(jax.devices()[:4]), ("kf",))
    poses1, L1 = ba_shard.local_deformable_ba_kf_sharded(
        kf_mesh, CAM, poses_true, L0, problem)
    assert np.isfinite(np.asarray(L1[:5])).all()
    assert np.isfinite(np.asarray(poses1.t[:5])).all()


def test_dryrun_multichip_entry():
    import __graft_entry__ as ge
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ge.dryrun_multichip(8)
