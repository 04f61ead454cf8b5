"""Core nonlinear least-squares machinery: Huber IRLS + Levenberg-Marquardt.

JAX-native replacement for g2o's OptimizationAlgorithmLevenberg +
RobustKernelHuber (used by every driver in
/root/reference/modules/optimization/g2o_optimization.cc). The drivers build
batched edge arrays and per-edge analytic Jacobian blocks; this module
provides the shared scalar pieces and a matrix-free preconditioned CG for the
large coupled systems (pose+deformation, bundle adjustment) where g2o used
sparse Cholesky.

LM schedule follows g2o's Levenberg implementation: lambda0 = tau * max
diag(H) with tau = 1e-5, gain-ratio-based lambda update
``lambda *= max(1/3, 1 - (2*rho - 1)^3)`` on success, ``lambda *= nu; nu *= 2``
on failure.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

LM_TAU = 1e-5


def selmm(spec: str, S: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Edge-selector einsum with ``x`` rounded to bfloat16, summed in f32.

    ``S`` is a 0/±1 selector matrix (exactly representable in bfloat16); ``x``
    is rounded to bfloat16. These [E, P]-selector products implement the
    edge gather/scatter of every coupled solver and are its bandwidth hot
    spot; bf16 operands halve their memory traffic while the sum accumulates
    in f32. The ~0.4% rounding on ``x`` only perturbs Gauss-Newton
    *directions* (gradients/Hv products); step acceptance always uses exact
    f32 chi2, so the LM iteration stays safe.

    The rounding is the same on every backend. The CPU runtime cannot run
    every bf16 x bf16 -> f32 dot ("Unsupported element type for DotThunk"),
    so where the program is lowered for the CPU the same products run as an
    f32 einsum of the rounded operands: each product of a 0/±1 entry with a
    bf16 value is exact in f32, so only the summation order can differ.
    """
    xb = x.astype(jnp.bfloat16)

    def bf16_dot(S, xb):
        return jnp.einsum(spec, S.astype(jnp.bfloat16), xb,
                          preferred_element_type=jnp.float32)

    def f32_dot(S, xb):
        return jnp.einsum(spec, S.astype(jnp.float32), xb.astype(jnp.float32),
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)

    return jax.lax.platform_dependent(S, xb, cpu=f32_dot, default=bf16_dot)


def selmm_exact(spec: str, S: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Exact f32 selector einsum — for RESIDUAL terms.

    With a ±1 two-nonzero selector row, the f32 matmul computes exactly
    ``x_i - x_j`` (each product is exact, and the two-term sum rounds like
    the plain subtraction), so this is a drop-in for row gathers wherever
    chi2-grade precision is required.

    Precision is pinned to HIGHEST: at JAX's *default* matmul precision an
    accelerator may compute f32 products in a reduced format (TF32 or
    bf16), which would make this silently no better than :func:`selmm`.
    """
    return jnp.einsum(spec, S.astype(jnp.float32), x.astype(jnp.float32),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / determinant).

    ``jnp.linalg.inv`` lowers to batched LU with pivoting — serial row
    operations; the cofactor formula is pure elementwise math that fuses
    with its neighbours. A must be well-conditioned (callers add LM damping
    to SPD blocks first).
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 0, det, 1.0)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], axis=-1),
        jnp.stack([A21, A22, A23], axis=-1),
        jnp.stack([A31, A32, A33], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def huber_weight(chi2: jnp.ndarray, delta2: float | jnp.ndarray) -> jnp.ndarray:
    """IRLS weight rho'(e2) of the Huber kernel with squared threshold delta2.

    Matches g2o::RobustKernelHuber::robustify: 1 inside the inlier region,
    delta/sqrt(e2) outside.
    """
    safe = jnp.maximum(chi2, 1e-20)
    return jnp.where(chi2 <= delta2, 1.0, jnp.sqrt(delta2 / safe))


def huber_rho(chi2: jnp.ndarray, delta2: float | jnp.ndarray) -> jnp.ndarray:
    """Robustified chi2 contribution rho(e2)."""
    delta = jnp.sqrt(delta2)
    return jnp.where(chi2 <= delta2,
                     chi2, 2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-20)) - delta2)


def lm_lambda_init(h_diag: jnp.ndarray) -> jnp.ndarray:
    return LM_TAU * jnp.max(h_diag)


def lm_lambda_update(lam, nu, rho_gain):
    """(new_lambda, new_nu, accepted) from the gain ratio."""
    accepted = rho_gain > 0
    shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho_gain - 1.0) ** 3)
    new_lam = jnp.where(accepted, lam * shrink, lam * nu)
    new_nu = jnp.where(accepted, 2.0, nu * 2.0)
    return new_lam, new_nu, accepted


def pcg(hvp: Callable[[jnp.ndarray], jnp.ndarray], b: jnp.ndarray,
        m_inv, iters: int, tol: float = 1e-8) -> jnp.ndarray:
    """Preconditioned conjugate gradient for H x = b.

    ``hvp`` must include any LM damping. ``m_inv`` is either a diagonal
    array or a callable applying a (block-)preconditioner. Fixed iteration
    count with an early-exit mask (static control flow for XLA). Replaces
    g2o's LinearSolverEigen/Dense for the coupled systems: the
    Hessian-vector products are batched einsums instead of a sparse
    factorization.
    """
    if not callable(m_inv):
        m_inv_arr = m_inv
        m_inv = lambda r: m_inv_arr * r
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = m_inv(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)
    b2 = jnp.vdot(b, b)

    # Fixed trip count (masked updates after convergence): XLA can schedule
    # and unroll a static-bound loop better than a data-dependent while.
    def body(_, state):
        x, r, p, rz, done = state
        hp = hvp(p)
        denom = jnp.vdot(p, hp)
        alpha = jnp.where(jnp.abs(denom) > 0, rz / denom, 0.0)
        alpha = jnp.where(done, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * hp
        z = m_inv(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(jnp.abs(rz) > 0, rz_new / rz, 0.0)
        p = z + beta * p
        done = done | (jnp.vdot(r, r) <= tol * tol * b2)
        return x, r, p, jnp.where(done, rz, rz_new), done

    x, *_ = jax.lax.fori_loop(0, iters, body,
                              (x0, r0, p0, rz0, jnp.array(False)))
    return x


def solve_spd6(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Solve the SPD 6x6 system H y = g via a 3x3 block Schur complement.

    Everything reduces to :func:`inv3x3` + 3x3 matmuls — pure elementwise
    math, avoiding the serial batched-LU path of ``jnp.linalg.solve`` that
    the pose-only LM loop would otherwise hit every iteration.
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    g1 = g[..., :3]
    g2 = g[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - jnp.swapaxes(B, -1, -2) @ AinvB
    Sinv = inv3x3(S)
    Ainv_g1 = jnp.einsum("...ij,...j->...i", Ainv, g1)
    rhs2 = g2 - jnp.einsum("...ji,...j->...i", B, Ainv_g1)
    y2 = jnp.einsum("...ij,...j->...i", Sinv, rhs2)
    y1 = Ainv_g1 - jnp.einsum("...ij,...j->...i", AinvB, y2)
    return jnp.concatenate([y1, y2], axis=-1)


def inv_spd6(H: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SPD 6x6 inverse via the 3x3 block Schur complement."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - jnp.swapaxes(B, -1, -2) @ AinvB
    Sinv = inv3x3(S)
    TL = Ainv + AinvB @ Sinv @ jnp.swapaxes(AinvB, -1, -2)
    TR = -AinvB @ Sinv
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Sinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def solve_dense(H: jnp.ndarray, g: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Solve (H + lam*I) dx = -g for small dense systems (pose-only driver)."""
    n = H.shape[-1]
    Hd = H + lam * jnp.eye(n, dtype=H.dtype)
    if n == 6:
        return -solve_spd6(Hd, g)
    return -jnp.linalg.solve(Hd, g)
