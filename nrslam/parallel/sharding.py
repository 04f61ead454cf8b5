"""Multi-device sharding of the SLAM state over a jax.sharding.Mesh.

The reference is strictly single-process (SURVEY.md §2.3); distribution is a
new capability of this framework. The design follows the standard XLA SPMD
recipe: pick a mesh, annotate shardings on the state pytree, and let the
partitioner insert the collectives.

Axes:
- ``pt``  — the landmark-slot axis. The front-end (KLT windows, residual
  rows, graph rows) is embarrassingly parallel over points; the reductions
  (6x6 pose normal equations, chi2 totals, CG dot products) become psums
  over ICI. The dense [P, P] graph shards by rows.
- ``kf``  — the keyframe axis for bundle adjustment (kept replicated in this
  revision; the window is small and the per-KF landmark copies already shard
  over ``pt``).

``shard_state`` places a SlamState so that every [P, ...] array is sharded on
its point axis and everything else is replicated. The jitted pipeline steps
then run unchanged — XLA partitions the einsums/gathers/scatters and inserts
all_gathers for the pair-edge indexing and psums for the reductions.

Also provided: an explicit shard_map implementation of the pose-only solve
(``pose_system_shard_map``) as the hand-written collective pattern for the
hot path (each device reduces its landmark shard's 6x6 block; one psum over
``pt`` yields the global normal equations).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nrslam.geometry import cameras, se3
from nrslam.slam import state as state_mod
from nrslam.solver import core


def make_mesh(devices=None, axis: str = "pt") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.array(devices), (axis,))


def _spec_for(path_leaf_shape, max_points):
    """PartitionSpec sharding any axis whose extent == max_points."""
    spec = []
    for d in path_leaf_shape:
        if d == max_points and "pt" not in spec:
            spec.append("pt")
        else:
            spec.append(None)
    return P(*spec)


def shard_state(state: state_mod.SlamState, mesh: Mesh,
                max_points: int) -> state_mod.SlamState:
    """Place every [..., P, ...] array sharded over the ``pt`` axis."""
    def place(x):
        if not hasattr(x, "shape") or x.ndim == 0:
            return x
        spec = _spec_for(x.shape, max_points)
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(place, state)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sharding), tree)


# ---------------------------------------------------------------------------
# Explicit shard_map pose solve (hand-written collective pattern)
# ---------------------------------------------------------------------------

def pose_system_shard_map(mesh: Mesh, cam: cameras.Camera):
    """Build a shard_map'd function computing the global 6x6 pose normal
    equations from point shards.

    Each device holds a shard of (landmarks, observations, weights); computes
    its partial H [6, 6] and g [6]; one psum over ``pt`` (ICI all-reduce)
    produces the global system on every device.
    """
    shard_map = jax.shard_map
    from nrslam.solver import residuals

    def local_system(Tq, Tt, X, obs, w):
        Tcw = se3.SE3(Tq, Tt)
        e, J, _ = residuals.reprojection(cam, Tcw, X, obs)
        chi2 = jnp.sum(e * e, axis=-1)
        wh = core.huber_weight(chi2, 5.99) * w
        H = jnp.einsum("pri,p,prj->ij", J, wh, J)
        g = jnp.einsum("pri,p,pr->i", J, wh, e)
        return (jax.lax.psum(H, "pt"), jax.lax.psum(g, "pt"))

    return shard_map(
        local_system, mesh=mesh,
        in_specs=(P(), P(), P("pt"), P("pt"), P("pt")),
        out_specs=(P(), P()),
    )
