"""nrslam — non-rigid monocular SLAM in JAX.

A from-scratch re-design of the capabilities of NR-SLAM (endomapper/NR-SLAM)
as jitted array programs:

- Shi-Tomasi detection and illumination-invariant pyramidal Lucas-Kanade
  tracking as batched device kernels over image pyramids (``nrslam.ops``).
- A Dynamic Deformation Graph with visco-elastic (spring + damper)
  regularization held as dense masked edge-state arrays (``nrslam.slam``).
- Camera-pose, pose+deformation, deformable-triangulation and local deformable
  bundle-adjustment solvers as JAX-native Levenberg-Marquardt with
  matrix-free preconditioned CG (``nrslam.solver``) — the g2o replacement.
- Essential-matrix monocular initialization with batched RANSAC scoring
  (``nrslam.slam.initializer``).
- Multi-device sharding of the point and keyframe axes via jax.sharding
  (``nrslam.parallel``).

Design stance (see SURVEY.md §7): fixed-capacity masked arrays instead of
pointer graphs, static factor layouts instead of dynamic edge sets, fixed
iteration budgets with masking instead of data-dependent control flow.
"""

__version__ = "0.1.0"
