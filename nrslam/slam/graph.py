"""Dynamic Deformation Graph as dense masked edge-state matrices.

Dense re-design of the reference's RegularizationGraph
(/root/reference/modules/map/regularization_graph.{h,cc}): instead of nested
btree maps of edge pointers, all pairwise edge state lives in dense [P, P]
arrays (symmetric, diagonal unused). P is the fixed landmark-slot capacity;
``exists`` masks real edges. Dense [P, P] elementwise updates and row-wise
top-k are regular array ops with no data-dependent structure.

Edge state and semantics (regularization_graph.h:41-58, .cc:38-128):
- ``first_distance``: distance at edge creation (spring rest length)
- ``max_distance`` / ``min_distance``: running extremes
- ``weight = exp(-max_distance^2 / (2 sigma^2))`` — Gaussian RBF of the
  LARGEST observed distance (re-evaluated on update, .cc:110)
- ``bad``: pruned when relative stretch (max-min)/min exceeds 1.1 (.cc:117)
- eligibility cutoff: weight >= weight(1.5 sigma) = exp(-1.125) (.cc:30)

The VERIFIED/NEIGHBOR statuses of the reference enum are never assigned by
any code path there, so edges here are just (exists, bad).

Design limit: the six [P, P] edge arrays (plus [P, P, 3] distance
temporaries inside updates) are quadratic in the slot capacity — at the
tested P <= 1024 each is <= 4 MB and the dense elementwise update is
simple and regular, but past P ~ 4096 the arrays reach 64 MB each
and the update becomes the frame's bandwidth bottleneck. Raising
``Config.max_points`` beyond a few thousand calls for switching
``update_vertices``/``top_k_neighbors`` to a banded/neighbor-list form
(each point only ever interacts with its K nearest); the solvers already
consume the graph through the compacted K-neighbor table, so the change is
local to this module.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import math

STRETCH_THRESHOLD = 1.1          # map.cc:29 (streching_th)
MIN_WEIGHT = math.exp(-1.125)    # InterpolationWeight(1.5*sigma, sigma)


def rbf_weight(distance, sigma):
    """InterpolationWeight (geometry_toolbox.cc:26-28)."""
    return jnp.exp(-(distance * distance) / (2.0 * sigma * sigma))


class GraphState(NamedTuple):
    exists: jnp.ndarray          # [P, P] bool (symmetric)
    bad: jnp.ndarray             # [P, P] bool
    first_distance: jnp.ndarray  # [P, P]
    max_distance: jnp.ndarray    # [P, P]
    min_distance: jnp.ndarray    # [P, P]
    weight: jnp.ndarray          # [P, P]
    sigma: jnp.ndarray           # scalar RBF sigma


def empty(capacity: int, sigma: float = 10.5) -> GraphState:
    z = jnp.zeros((capacity, capacity), jnp.float32)
    f = jnp.zeros((capacity, capacity), bool)
    return GraphState(exists=f, bad=f, first_distance=z, max_distance=z,
                      min_distance=z, weight=z, sigma=jnp.float32(sigma))


def _pair_distances(positions):
    d = positions[:, None, :] - positions[None, :, :]
    return jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-20))


def initialize(graph: GraphState, positions: jnp.ndarray, valid: jnp.ndarray,
               sigma) -> GraphState:
    """All-pairs initialization over the valid landmark slots.

    Map::InitializeRegularizationGraph (map.cc:139-167) densely connects every
    landmark pair after monocular init, with sigma = 3 * depth-sigma * scale.
    """
    P = positions.shape[0]
    dist = _pair_distances(positions)
    pair = valid[:, None] & valid[None, :] & ~jnp.eye(P, dtype=bool)
    sigma = jnp.asarray(sigma, jnp.float32)
    return GraphState(
        exists=pair,
        bad=jnp.zeros_like(pair),
        first_distance=jnp.where(pair, dist, 0.0),
        max_distance=jnp.where(pair, dist, 0.0),
        min_distance=jnp.where(pair, dist, 0.0),
        weight=jnp.where(pair, rbf_weight(dist, sigma), 0.0),
        sigma=sigma,
    )


def add_edges(graph: GraphState, positions: jnp.ndarray, new_mask: jnp.ndarray,
              existing_mask: jnp.ndarray) -> GraphState:
    """Connect every new landmark to every existing landmark.

    Mapping inserts a full star for each triangulated landmark
    (mapping.cc:238-257). ``new_mask``/``existing_mask`` are [P] bools.
    """
    P = positions.shape[0]
    dist = _pair_distances(positions)
    pair_new = ((new_mask[:, None] & existing_mask[None, :])
                | (existing_mask[:, None] & new_mask[None, :])
                | (new_mask[:, None] & new_mask[None, :]))
    pair_new = pair_new & ~jnp.eye(P, dtype=bool) & ~graph.exists
    w = rbf_weight(dist, graph.sigma)
    return graph._replace(
        exists=graph.exists | pair_new,
        bad=jnp.where(pair_new, False, graph.bad),
        first_distance=jnp.where(pair_new, dist, graph.first_distance),
        max_distance=jnp.where(pair_new, dist, graph.max_distance),
        min_distance=jnp.where(pair_new, dist, graph.min_distance),
        weight=jnp.where(pair_new, w, graph.weight),
    )


def update_vertices(graph: GraphState, positions: jnp.ndarray,
                    update_mask: jnp.ndarray):
    """Batched RegularizationGraph::UpdateVertex over a set of landmarks.

    For every edge incident to a landmark in ``update_mask``: refresh the
    distance extremes from current positions, recompute the weight from the
    max distance, and prune (bad) on relative stretch > 1.1
    (regularization_graph.cc:89-146). Returns (graph, good_connections [P])
    where good counts edges currently passing the stretch test — the quantity
    CameraPoseAndDeformationOptimization compares against
    regularizers_per_point/2 (g2o_optimization.cc:466-473).
    """
    dist = _pair_distances(positions)
    touched = (update_mask[:, None] | update_mask[None, :]) & graph.exists
    max_d = jnp.where(touched, jnp.maximum(graph.max_distance, dist),
                      graph.max_distance)
    min_d = jnp.where(touched, jnp.minimum(graph.min_distance, dist),
                      graph.min_distance)
    weight = jnp.where(touched, rbf_weight(max_d, graph.sigma), graph.weight)
    stretch_bad = jnp.abs((max_d - min_d) / jnp.maximum(min_d, 1e-12)) > STRETCH_THRESHOLD
    bad = graph.bad | (touched & stretch_bad)
    good = jnp.sum((touched & ~stretch_bad).astype(jnp.int32), axis=1)
    new_graph = graph._replace(max_distance=max_d, min_distance=min_d,
                               weight=weight, bad=bad)
    return new_graph, good


def top_k_neighbors(graph: GraphState, eligible: jnp.ndarray, k: int):
    """Per-landmark top-k usable neighbors by weight.

    Mirrors GetEdges (sorted by weight, truncated below the 1.5-sigma weight
    cutoff, BAD edges excluded — regularization_graph.cc:61-87 + the callers'
    status checks) followed by the <= regularizers_per_point selection loop.

    Args:
      eligible: [P] bool — neighbor candidates (e.g. TRACKED_WITH_3D slots).

    Returns (idx [P, k], weight [P, k], first_distance [P, k], valid [P, k]).
    """
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT) \
        & eligible[None, :]
    scores = jnp.where(usable, graph.weight, -1.0)
    top_w, top_idx = jax.lax.top_k(scores, k)
    valid = top_w > 0.0
    d0 = jnp.take_along_axis(graph.first_distance, top_idx, axis=1)
    return top_idx, jnp.maximum(top_w, 0.0), d0, valid


def neighborhood_rings(graph: GraphState, seed_mask: jnp.ndarray, k: int):
    """0th/1st/2nd-order neighborhood rings of a seed landmark set.

    Masked-array analogue of GetOptimizationNeighbours
    (regularization_graph.cc:159-232, currently unused by reference callers
    but part of its public surface): ring0 = seeds, ring1 = top-k usable
    neighbors of seeds outside the seed set, ring2 = top-k usable neighbors
    of ring1 outside rings 0/1. Returns (ring0, ring1, ring2) bool [P].
    """
    usable = graph.exists & ~graph.bad & (graph.weight >= MIN_WEIGHT)

    def expand(frontier, excluded):
        scores = jnp.where(usable & frontier[:, None], graph.weight, -1.0)
        topw, topi = jax.lax.top_k(scores, k)
        P = frontier.shape[0]
        hit = jnp.zeros(P, bool).at[topi.reshape(-1)].max(
            (topw > 0).reshape(-1))
        return hit & ~excluded

    ring0 = seed_mask
    ring1 = expand(ring0, ring0)
    ring2 = expand(ring1, ring0 | ring1)
    return ring0, ring1, ring2


def remove_landmarks(graph: GraphState, remove_mask: jnp.ndarray) -> GraphState:
    """Drop all edges incident to removed landmark slots (slot recycling)."""
    keep = ~remove_mask
    pair = keep[:, None] & keep[None, :]
    return graph._replace(exists=graph.exists & pair,
                          bad=graph.bad & pair)
