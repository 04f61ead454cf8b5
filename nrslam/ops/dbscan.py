"""DBSCAN clustering over pairwise distances (device-friendly).

Replacement for the mlpack-backed wrappers in
/root/reference/modules/utilities/dbscan.cc. Point counts are small (<= a few
thousand), so the dense [N, N] adjacency + iterated label propagation maps
cleanly onto dense array math:

- 2D variant: eps=0.2 on norm-normalized coordinates, min_pts=3 (dbscan.cc:30-46)
- 3D variant: eps=2.5, min_pts=5, clusters relabeled by descending size
  (dbscan.cc:49-96)
- ND variant: eps=0.1*dim, min_pts=10 (dbscan.cc:99-131) — used on optical
  flow tracks during initialization (visualization-only in the reference).

Labels: 0.. for clusters, -1 for noise. Cluster ids are relabeled by
descending cluster size (the reference's SortClusters behavior for 3D; we
apply it uniformly — downstream only compares labels/size order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dbscan_dense(X: jnp.ndarray, valid: jnp.ndarray, eps: float,
                  min_pts: int, max_iters: int = 64):
    """Core DBSCAN via label propagation on the core-point graph."""
    N = X.shape[0]
    d2 = jnp.sum((X[:, None] - X[None]) ** 2, axis=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    # neighbor count includes self (mlpack convention counts the point).
    n_nbr = jnp.sum(adj, axis=1)
    core = valid & (n_nbr >= min_pts)

    # Propagate minimum index through the core-core graph (connected
    # components); border points then adopt the label of any core neighbor.
    core_adj = adj & core[:, None] & core[None, :]
    labels = jnp.where(core, jnp.arange(N), N)

    def body(state):
        labels, _ = state
        new = jnp.min(jnp.where(core_adj, labels[None, :], N), axis=1)
        new = jnp.minimum(labels, new)
        return new, jnp.any(new != labels)

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.array(True)))

    # Border points: adopt the min core-neighbor label.
    border_label = jnp.min(jnp.where(adj & core[None, :], labels[None, :], N),
                           axis=1)
    labels = jnp.where(core, labels, border_label)
    is_noise = labels >= N

    # Compact labels + order clusters by size (descending).
    sizes = jnp.sum((labels[None, :] == jnp.arange(N)[:, None])
                    & ~is_noise[None, :], axis=1)
    order = jnp.argsort(-sizes)
    rank = jnp.zeros(N, jnp.int32).at[order].set(jnp.arange(N, dtype=jnp.int32))
    out = jnp.where(is_noise | ~valid, -1, rank[jnp.clip(labels, 0, N - 1)])
    return out


def dbscan_2d(points: jnp.ndarray, valid: jnp.ndarray | None = None):
    """Dbscan2D (dbscan.cc:30-46): coordinates divided by their max norm."""
    valid = jnp.ones(points.shape[0], bool) if valid is None else valid
    norms = jnp.linalg.norm(points, axis=-1)
    scale = jnp.maximum(jnp.max(jnp.where(valid, norms, 0.0)), 1e-12)
    return _dbscan_dense(points / scale, valid, eps=0.2, min_pts=3)


def dbscan_3d(points: jnp.ndarray, valid: jnp.ndarray | None = None,
              eps: float = 2.5):
    """Dbscan3D (dbscan.cc:49-96); eps is per-sequence in the reference."""
    valid = jnp.ones(points.shape[0], bool) if valid is None else valid
    return _dbscan_dense(points, valid, eps=eps, min_pts=5)


def dbscan_nd(tracks: jnp.ndarray, valid: jnp.ndarray | None = None):
    """DbscanND (dbscan.cc:99-131): eps = 0.1 * dim, min_pts=10."""
    valid = jnp.ones(tracks.shape[0], bool) if valid is None else valid
    eps = 0.1 * tracks.shape[-1]
    return _dbscan_dense(tracks, valid, eps=eps, min_pts=10)
