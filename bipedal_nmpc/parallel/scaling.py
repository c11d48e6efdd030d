"""Multi-chip / multi-host scaling harness.

The scenario batch is the unit of scale-out (SURVEY.md §5.8): within a host
the batch axis shards over ICI; across hosts it shards over DCN.  This module
provides

- :func:`make_two_level_mesh` — a ("dcn", "ici") mesh so shardings can keep
  the fast collectives on ICI and only batch-partitioning on DCN (the
  scaling-book recipe: data-parallel outer axis over DCN, everything
  latency-sensitive inner);
- :func:`fleet_stats` — collective-reduced fleet telemetry (mean cost, mean
  /max defect, acceptance rate) computed on-device with `psum`/`pmax` via
  `shard_map`, replacing the reference's ROS-topic aggregation of per-robot
  observers;
- :func:`run_scaling_benchmark` — solves/s at mesh sizes 1, 2, 4, .., N for
  the weak-scaling table (fixed per-device batch).

On real multi-host slices the same code runs unmodified under
`jax.distributed.initialize()`; on a dev box it runs on the virtual CPU mesh
(xla_force_host_platform_device_count).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .batch_solver import make_batched_solver


def make_two_level_mesh(n_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """("dcn", "ici") mesh: outer axis = hosts (DCN), inner = chips (ICI).

    On a real slice, pass devices ordered host-major (jax.devices() already
    is); n_hosts * chips_per_host must equal len(devices)."""
    devices = devices if devices is not None else jax.devices()
    if n_hosts * chips_per_host != len(devices):
        raise ValueError(
            f"mesh {n_hosts}x{chips_per_host} != {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_hosts, chips_per_host)
    return Mesh(arr, ("dcn", "ici"))


def batch_spec(mesh: Mesh) -> P:
    """Batch axis sharded over every mesh axis (data-parallel over DCN x ICI)."""
    return P(tuple(mesh.axis_names))


def fleet_stats(mesh: Mesh, sol_cost, sol_defect, sol_step):
    """Collective-reduced fleet telemetry.

    Inputs are per-scenario arrays (batch,) sharded over the mesh; returns
    replicated scalars (mean cost, mean defect, max defect, step-acceptance
    rate).  The reductions ride ICI within a host and DCN across hosts —
    this is the framework's equivalent of the reference's observation
    aggregation topics (BipedalController.cpp:275,316).
    """
    spec = batch_spec(mesh)

    def stats(cost, defect, step):
        axes = mesh.axis_names
        n = jax.lax.psum(jnp.asarray(cost.shape[0], cost.dtype), axes)
        mean_cost = jax.lax.psum(jnp.sum(cost), axes) / n
        mean_defect = jax.lax.psum(jnp.sum(defect), axes) / n
        max_defect = jax.lax.pmax(jnp.max(defect), axes)
        accept = jax.lax.psum(jnp.sum((step > 0).astype(cost.dtype)), axes) / n
        return mean_cost, mean_defect, max_defect, accept

    fn = jax.shard_map(
        stats,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(fn)(sol_cost, sol_defect, sol_step)


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    n_hosts: int
    batch: int
    solves_per_s: float
    solves_per_s_per_device: float
    mean_defect: float


def run_scaling_benchmark(
    model,
    info,
    settings,
    Q,
    R,
    refs,
    t_nodes,
    x0,
    xs,
    us,
    per_device_batch: int = 32,
    steps: int = 5,
    warmup: int = 2,
    chips_per_host: int | None = None,
) -> list[ScalingPoint]:
    """Weak-scaling sweep: fixed per-device batch, mesh sizes 1,2,4,..,N.

    Single-scenario reference data (refs, t_nodes, x0, xs, us) is tiled to
    the global batch for each mesh size.  When chips_per_host is given and
    divides the mesh size, a two-level ("dcn","ici") mesh is used; otherwise
    a flat ("data",) mesh.
    """
    devices = jax.devices()
    sizes = []
    n = 1
    while n <= len(devices):
        sizes.append(n)
        n *= 2
    if sizes[-1] != len(devices):
        sizes.append(len(devices))

    points = []
    for n_dev in sizes:
        devs = devices[:n_dev]
        if chips_per_host and n_dev % chips_per_host == 0 and n_dev > chips_per_host:
            n_hosts = n_dev // chips_per_host
            mesh = make_two_level_mesh(n_hosts, chips_per_host, devs)
        else:
            n_hosts = 1
            mesh = Mesh(np.asarray(devs), ("data",))
        spec = batch_spec(mesh)
        sharding = NamedSharding(mesh, spec)
        B = per_device_batch * n_dev
        tile = lambda a: jax.device_put(
            np.broadcast_to(np.asarray(a)[None], (B,) + np.asarray(a).shape).copy(), sharding
        )
        refs_b = jax.tree.map(tile, refs)
        t_b, x_b = tile(t_nodes), tile(x0)
        xs_b, us_b = tile(xs), tile(us)
        solver = make_batched_solver(
            model, info, settings, Q, R, mesh=mesh, axis_name=spec, donate_warm_start=False
        )
        for _ in range(warmup):
            sol = solver(refs_b, t_b, x_b, xs_b, us_b)
            xs_b, us_b = sol.x_traj, sol.u_traj
        jax.block_until_ready(sol.x_traj)
        t0 = time.perf_counter()
        for _ in range(steps):
            sol = solver(refs_b, t_b, x_b, xs_b, us_b)
            xs_b, us_b = sol.x_traj, sol.u_traj
        jax.block_until_ready(sol.x_traj)
        dt = time.perf_counter() - t0
        _, mean_defect, _, _ = fleet_stats(mesh, sol.cost, sol.defect_norm, sol.step_size)
        sps = B * steps / dt
        points.append(
            ScalingPoint(
                n_devices=n_dev,
                n_hosts=n_hosts,
                batch=B,
                solves_per_s=round(sps, 2),
                solves_per_s_per_device=round(sps / n_dev, 2),
                mean_defect=float(mean_defect),
            )
        )
    return points
