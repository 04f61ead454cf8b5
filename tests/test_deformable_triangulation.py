import jax
import jax.numpy as jnp
import numpy as np

from nrslam.geometry import cameras, se3
from nrslam.solver import deformable_triangulation as dt


CAM = cameras.pinhole(472.65, 472.65, 479.5, 359.5)
RAD_PER_PIXEL = 0.002


def make_inputs(n_cand=8, n_frames=10, nb=6, deform_amp=0.0, seed=0):
    """Camera translating sideways viewing a (possibly deforming) point set."""
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 6)

    # Buffer-frame camera poses: sweep along x.
    ts = jnp.linspace(0, 0.4, n_frames)
    Tcw = se3.SE3(
        q=jnp.broadcast_to(jnp.array([1.0, 0, 0, 0]), (n_frames, 4)),
        t=jnp.stack([ts, jnp.zeros_like(ts), jnp.zeros_like(ts)], -1),
    )

    def sample_pts(k, n):
        return jnp.stack([
            jax.random.uniform(k, (n,), minval=-0.8, maxval=0.8),
            jax.random.uniform(jax.random.fold_in(k, 1), (n,), minval=-0.6, maxval=0.6),
            jax.random.uniform(jax.random.fold_in(k, 2), (n,), minval=2.5, maxval=3.5),
        ], -1)

    cand_rest = sample_pts(ks[0], n_cand)        # [C, 3] candidate GT rest
    nbr_rest = sample_pts(ks[1], n_cand * nb).reshape(n_cand, nb, 3)

    # Deformation: shared smooth motion per frame (candidates + neighbors move
    # together — that's what the damper model assumes).
    phase = jnp.linspace(0, 2 * jnp.pi, n_frames)
    def deform(X, t_idx):
        d = deform_amp * jnp.stack([
            jnp.sin(X[..., 0] + phase[t_idx]),
            jnp.cos(X[..., 1] + phase[t_idx]),
            0.3 * jnp.sin(phase[t_idx]) * jnp.ones_like(X[..., 0]),
        ], -1)
        return X + d

    obs = []
    cand_true_per_frame = []
    nbr_pos = []
    for t in range(n_frames):
        ct = deform(cand_rest, t)
        cand_true_per_frame.append(ct)
        obs.append(cameras.project(CAM, se3.apply(se3.index(Tcw, t), ct)))
        nbr_pos.append(deform(nbr_rest, t))
    obs = jnp.stack(obs, axis=1)                      # [C, T, 2]
    nbr_pos = jnp.stack(nbr_pos, axis=2)              # [C, NB, T, 3]

    inputs = dt.TriangulationInputs(
        obs=obs,
        track_valid=jnp.ones((n_cand, n_frames), bool),
        nbr_pos=nbr_pos,
        nbr_valid=jnp.ones((n_cand, nb, n_frames), bool),
        cand_valid=jnp.ones(n_cand, bool),
    )
    cand_true_last = cand_true_per_frame[-1]
    return inputs, Tcw, cand_true_last


def test_rigid_candidates_triangulated():
    inputs, Tcw, gt_last = make_inputs(deform_amp=0.0)
    X, ok = dt.deformable_triangulate(CAM, inputs, Tcw, RAD_PER_PIXEL)
    ok = np.asarray(ok)
    assert ok.mean() > 0.7, ok
    err = np.linalg.norm(np.asarray(X) - np.asarray(gt_last), axis=-1)[ok]
    assert np.median(err) < 0.05, np.median(err)


def test_deforming_candidates_triangulated():
    inputs, Tcw, gt_last = make_inputs(deform_amp=0.03, seed=1)
    X, ok = dt.deformable_triangulate(CAM, inputs, Tcw, RAD_PER_PIXEL)
    ok = np.asarray(ok)
    assert ok.mean() > 0.5, ok
    err = np.linalg.norm(np.asarray(X) - np.asarray(gt_last), axis=-1)[ok]
    assert np.median(err) < 0.12, np.median(err)


def test_short_track_rejected():
    inputs, Tcw, _ = make_inputs()
    tv = inputs.track_valid.at[:, 3:].set(False)  # 3-frame tracks
    inputs = inputs._replace(track_valid=tv)
    _, ok = dt.deformable_triangulate(CAM, inputs, Tcw, RAD_PER_PIXEL)
    assert not np.asarray(ok).any()


def test_no_neighbors_rejected():
    inputs, Tcw, _ = make_inputs()
    inputs = inputs._replace(nbr_valid=jnp.zeros_like(inputs.nbr_valid))
    _, ok = dt.deformable_triangulate(CAM, inputs, Tcw, RAD_PER_PIXEL)
    assert not np.asarray(ok).any()
