import jax
import jax.numpy as jnp
import numpy as np

from nrslam.datasets import synthetic
from nrslam.geometry import cameras, se3
from nrslam.ops import klt
from nrslam.slam import graph as graph_mod
from nrslam.slam import state as state_mod
from nrslam.slam import system as system_mod
from nrslam.slam.state import Config


def test_stereo_bootstrap():
    scene = synthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
    cam = synthetic.camera(scene)
    config = Config(max_points=64, max_keyframes=3, temporal_window=4,
                    klt_levels=3, klt_win=11)
    gray, depth, _ = synthetic.render_frame(0, scene)
    pyr = klt.build_pyramid(gray, config.klt_config)

    n = 64
    key = jax.random.PRNGKey(0)
    kps = jnp.stack([
        15 + 98 * jax.random.uniform(key, (n,)),
        15 + 66 * jax.random.uniform(jax.random.fold_in(key, 1), (n,)),
    ], -1)
    from nrslam.ops import image as image_ops
    depths = image_ops.bilinear_sample(depth, kps)
    rays = cameras.unproject(cam, kps)
    landmarks = rays * depths[:, None]
    ok = jnp.ones(n, bool)
    ids = jnp.arange(n, dtype=jnp.int32)

    state = state_mod.empty_state(config, gray.shape)
    state = system_mod.bootstrap_map_stereo(state, kps, landmarks, ok, ids,
                                            pyr, config)
    assert int(jnp.sum(state.slot_used)) == n
    assert int(jnp.sum(state.kf_valid)) == 1
    assert float(state.scale) == 1.0
    assert bool(jnp.any(state.graph.exists))


def test_neighborhood_rings():
    pos = jnp.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0], [50, 0, 0]])
    gr = graph_mod.initialize(graph_mod.empty(5), pos, jnp.ones(5, bool), 2.0)
    ring0 = jnp.array([True, False, False, False, False])
    r0, r1, r2 = graph_mod.neighborhood_rings(gr, ring0, k=2)
    assert bool(r1[1]) and bool(r1[2])       # 2 nearest neighbors of 0
    assert not bool(r1[0])
    assert bool(r2[3])                        # neighbor-of-neighbor
    assert not bool(r2[4])                    # far point below weight cutoff


def test_auto_reinitialize_flag():
    scene = synthetic.SceneConfig(height=96, width=128, fx=100.0, fy=100.0)
    cam = synthetic.camera(scene)
    sys = system_mod.System(cam, Config(max_points=64),
                            auto_reinitialize=True)
    assert sys.auto_reinitialize
