"""Matmul-precision policy for the framework's jitted entry points.

On an NVIDIA GPU, XLA may run a float32 ``dot_general`` at default precision
in TF32 on the tensor cores (~10 mantissa bits, about three decimal digits).
For this framework's small, ill-conditioned tensor algebra — physics
mass-matrix solves, stage-KKT factorizations, contact Jacobian products —
that is a correctness hazard, not a speed-up: the operands are 3-24 wide, so
the tensor cores have little to gain, and the stage KKT amplifies round-off
by its conditioning (see chip_smoke.py).

All production jit entry points (sim/batch_loop, runtime/mpc_runner,
parallel/batch_solver, bench.py) therefore trace under
:func:`default_matmul_precision`, which is full ``float32`` ("highest":
IEEE float32 products, never TF32) unless overridden.  The Triton Riccati
kernel sets the same precision on each of its own products
(ops/riccati_triton.py).  Precedence: the ``BIPEDAL_MATMUL_PRECISION`` env
var (explicit experiment override) beats a per-robot ``matmulPrecision``
key in task.info/overrides.info (deployment config, config/loader.py) beats
the "float32" default.  Valid values: "float32", "tensorfloat32",
"bfloat16_3x", "bfloat16" (see ``jax.default_matmul_precision``).

There is no analogue in the reference (CPU/ROS C++ on Eigen doubles never
faces a reduced-precision matrix unit).
"""
from __future__ import annotations

import os

import jax


def matmul_precision(configured: str | None = None) -> str:
    """The effective precision name (env > per-robot config > default)."""
    return os.environ.get("BIPEDAL_MATMUL_PRECISION") or configured or "float32"


def default_matmul_precision(configured: str | None = None):
    """Context manager: trace enclosed ops at the effective precision.

    ``configured`` is the per-robot task value (TaskConfig.matmul_precision)
    where the caller has an interface in scope; entry points without one use
    the plain default."""
    return jax.default_matmul_precision(matmul_precision(configured))
