import jax
import jax.numpy as jnp
import numpy as np

from nrslam.slam import graph as g


def test_initialize_all_pairs():
    pos = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 2, 0], [9, 9, 9]])
    valid = jnp.array([True, True, True, False])
    gr = g.initialize(g.empty(4), pos, valid, sigma=2.0)
    assert bool(gr.exists[0, 1]) and bool(gr.exists[1, 2])
    assert not bool(gr.exists[0, 3]) and not bool(gr.exists[0, 0])
    np.testing.assert_allclose(gr.first_distance[0, 1], 1.0, atol=1e-6)
    np.testing.assert_allclose(gr.weight[0, 1], np.exp(-1.0 / 8.0), atol=1e-5)


def test_update_and_stretch_prune():
    pos0 = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    valid = jnp.ones(3, bool)
    gr = g.initialize(g.empty(3), pos0, valid, sigma=5.0)
    # stretch edge (0,1) beyond 1.1x relative
    pos1 = pos0.at[1, 0].set(2.2)
    gr2, good = g.update_vertices(gr, pos1, jnp.array([True, False, False]))
    assert bool(gr2.bad[0, 1]) and bool(gr2.bad[1, 0])
    assert not bool(gr2.bad[0, 2])
    # weight re-evaluated at max distance
    np.testing.assert_allclose(gr2.max_distance[0, 1], 2.2, atol=1e-5)
    assert int(good[0]) == 1  # only edge (0,2) still passes


def test_update_tracks_min_distance():
    pos0 = jnp.array([[0.0, 0, 0], [1, 0, 0]])
    gr = g.initialize(g.empty(2), pos0, jnp.ones(2, bool), sigma=5.0)
    pos1 = pos0.at[1, 0].set(0.95)
    gr2, _ = g.update_vertices(gr, pos1, jnp.ones(2, bool))
    np.testing.assert_allclose(gr2.min_distance[0, 1], 0.95, atol=1e-5)
    np.testing.assert_allclose(gr2.max_distance[0, 1], 1.0, atol=1e-5)


def test_top_k_neighbors_ordering_and_cutoff():
    # 1D chain: closer points get larger weight
    pos = jnp.array([[0.0, 0, 0], [0.5, 0, 0], [1.2, 0, 0], [30.0, 0, 0]])
    gr = g.initialize(g.empty(4), pos, jnp.ones(4, bool), sigma=1.0)
    idx, w, d0, valid = g.top_k_neighbors(gr, jnp.ones(4, bool), 3)
    # neighbor 30 away has weight ~0 -> below cutoff -> invalid
    row0 = np.asarray(idx[0])[np.asarray(valid[0])]
    assert list(row0) == [1, 2]
    assert np.all(np.diff(np.asarray(w[0])) <= 1e-6)  # descending


def test_add_edges_star():
    pos = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    gr = g.initialize(g.empty(3), pos, jnp.array([True, True, False]), sigma=2.0)
    assert not bool(gr.exists[0, 2])
    gr2 = g.add_edges(gr, pos, jnp.array([False, False, True]),
                      jnp.array([True, True, False]))
    assert bool(gr2.exists[0, 2]) and bool(gr2.exists[2, 1])
    # existing edge untouched
    np.testing.assert_allclose(gr2.first_distance[0, 1], gr.first_distance[0, 1])


def test_remove_landmarks():
    pos = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    gr = g.initialize(g.empty(3), pos, jnp.ones(3, bool), sigma=2.0)
    gr2 = g.remove_landmarks(gr, jnp.array([False, True, False]))
    assert not bool(gr2.exists[0, 1]) and bool(gr2.exists[0, 2])
