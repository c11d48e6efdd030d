"""Scenario-batched MPC over device meshes.

This is the framework's "distributed backend" (SURVEY.md §2.4/§5.8): the
reference's thread pools become a scenario batch axis — thousands of
independent MPC problems (robots x gaits x terrains x horizon shifts) vmapped
per device and sharded over a one-axis `jax.sharding.Mesh` ("data"); the
solve is batch-parallel, so no collective runs inside it.

Each scenario carries its own reference tables (gait/swing/target), initial
state, and warm start; the solver program is identical across scenarios, so
one compiled executable serves the whole fleet.
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.problem import OcpSettings
from ..solver.sqp import sqp_solve
from ..utils.precision import default_matmul_precision


def batched_sqp_solve(model, info, settings, Q, R, refs_b, t_nodes_b, x_init_b, xs_b, us_b):
    """Batched SQP over a leading scenario axis on every argument."""
    return jax.vmap(
        lambda refs, t_nodes, x_init, xs, us: sqp_solve(
            model, info, settings, Q, R, refs, t_nodes, x_init, xs, us
        )
    )(refs_b, t_nodes_b, x_init_b, xs_b, us_b)


def make_mesh(axis_name: str = "data", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(tree, mesh: Mesh, axis_name: str = "data"):
    """Place a batched pytree with the leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def make_batched_solver(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    mesh: Mesh | None = None,
    axis_name: str = "data",
    donate_warm_start: bool = True,
):
    """Compile a batch-sharded solver.  Inputs must be batched on axis 0; when
    a mesh is given the batch axis is sharded across it (batch % n_devices == 0).
    """
    _f = partial(batched_sqp_solve, model, info, settings, Q, R)

    # full-f32 matmuls, never TF32 (utils/precision.py)
    def f(refs_b, t_nodes_b, x_init_b, xs_b, us_b):
        with default_matmul_precision():
            return _f(refs_b, t_nodes_b, x_init_b, xs_b, us_b)

    if mesh is None:
        return jax.jit(f, donate_argnums=(3, 4) if donate_warm_start else ())
    # axis_name may be a single mesh axis or a full PartitionSpec (e.g.
    # P(("dcn", "ici")) for the two-level multi-host mesh in scaling.py)
    spec = axis_name if isinstance(axis_name, P) else P(axis_name)
    sharding = NamedSharding(mesh, spec)
    # Each device solves its own shard of the batch: the solve has no
    # collectives, and the partitioner cannot split a Pallas kernel's batch
    # grid by itself.  check_vma=False because a kernel's outputs carry no
    # varying-mesh-axes type for the checker to verify.
    f = jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 5, out_specs=spec, check_vma=False)
    return jax.jit(
        f,
        in_shardings=(sharding,) * 5,
        out_shardings=sharding,
        donate_argnums=(3, 4) if donate_warm_start else (),
    )
