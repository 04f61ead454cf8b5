"""Matmul precision of the jitted SLAM programs."""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace ``fn`` with every float32 matmul pinned to full f32 precision.

    At JAX's default precision an accelerator may run a float32 matmul in a
    reduced format (TF32 on a GPU). The frame programs hold exact one-hot
    selections (KLT patch extraction, cluster sums) and badly conditioned
    small systems (the 8-point normal matrix, 3x3/6x6 block solves) as f32
    einsums, so they state their precision instead of inheriting it; the CPU
    tests run at the same precision, so the CPU and the GPU compute the same
    program. Deliberate bf16 products (``solver.core.selmm``) cast their
    operands and are unaffected. Apply below ``jax.jit``.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
