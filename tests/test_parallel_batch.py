"""Batched, mesh-sharded solving on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np


def test_batched_sharded_solve_tiny():
    """8 scenarios sharded over 8 CPU devices, tiny horizon: solutions match
    the unsharded single-scenario solve."""
    import dataclasses

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.parallel import make_batched_solver, make_mesh, shard_batch
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve

    iface = make_interface_for("g1")
    settings = dataclasses.replace(iface.settings, dt=0.125, sqp_iterations=1)
    rm = iface.make_reference_manager()
    rm.num_intervals = settings.num_intervals
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0, settings.num_intervals + 1)

    ref_sol = sqp_solve(
        iface.model, iface.info, settings, iface.Q, iface.R, refs, t_nodes, x0, xs, us
    )

    n_dev = len(jax.devices())
    assert n_dev >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh("data", jax.devices()[:8])
    B = 8
    tile = lambda a: jnp.broadcast_to(a[None], (B,) + a.shape)
    batch = (jax.tree.map(tile, refs), tile(t_nodes), tile(x0), tile(xs), tile(us))
    batch = shard_batch(batch, mesh, "data")
    solver = make_batched_solver(
        iface.model, iface.info, settings, iface.Q, iface.R, mesh, donate_warm_start=False
    )
    sol = solver(*batch)
    assert sol.x_traj.shape[0] == B
    for b in range(B):
        np.testing.assert_allclose(
            np.asarray(sol.x_traj[b]), np.asarray(ref_sol.x_traj), atol=1e-8
        )
