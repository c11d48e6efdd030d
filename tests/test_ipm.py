"""Primal-dual interior-point friction cones (cone="ipm", VERDICT r3 #7).

The reference can run OCS2's IPM solver as configured by the task.info ipm
block (task.info:86-156).  solver/sqp.py's cone="ipm" is the batch-friendly
primal-dual equivalent: per-node slack/dual iterates on the stance cones,
condensed Newton terms on the stage quadratics, fraction-to-boundary caps
with INDEPENDENT dual steps (usePrimalStepSizeForDual=false semantics — the
tied variant measurably stalls from infeasible starts), the primal cone
residual ||g - s||^2 in the filter-linesearch violation channel, and a
geometric central-path schedule mu_init -> mu_target.  All static-shape:
swing cones carry benign masked iterates, no per-constraint control flow.

Measured comparison on the cone-ACTIVE lateral-push scenario (CPU,
float64): the task-configured soft relaxed barrier
leaves the binding cone at g = -7.06 N (it is weak by configuration: large
delta, small mu); the primal-dual path pulls it to EXACTLY the boundary
(g = 0.000) with defect 1.4e-6 and only ~5 N of force adjustment — strict
feasibility is the IPM's win; throughput-critical batched RTI keeps the
one-iteration soft path (an order of magnitude fewer iterations).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import _require_h1


@pytest.fixture(scope="module")
def pushed():
    """H1 trot refs + a lateral push that makes the soft-path solution
    VIOLATE the cone (g_min ~ -7), plus the converged soft solution as the
    warm start (the RTI deployment shape: IPM refines the running policy)."""
    _require_h1()
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.solver.sqp import build_refs, initial_trajectory, sqp_solve

    iface = make_interface_for("h1")
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state).at[1].set(0.5).at[0].set(0.25)
    xs, us = initial_trajectory(iface.info, refs, x0, iface.settings.num_intervals + 1)
    soft = sqp_solve(
        iface.model, iface.info,
        dataclasses.replace(iface.settings, cone="soft", sqp_iterations=8),
        iface.Q, iface.R, refs, t_nodes, x0, xs, us,
    )
    return iface, refs, t_nodes, x0, soft


def _cone_values(iface, settings, u_traj):
    from bipedal_nmpc.ocp.problem import friction_cone_values

    return np.stack(
        [
            np.asarray(friction_cone_values(settings, u, iface.info))
            for u in np.asarray(u_traj)
        ]
    )


def test_barrier_mu_zero_is_inert():
    """cone="ipm" disables the soft barrier by barrier_mu=0; the relaxed
    barrier must vanish identically (incl. the quadratic extension)."""
    from bipedal_nmpc.ocp.problem import relaxed_barrier

    h = jnp.asarray([-5.0, -0.001, 0.0, 0.004, 0.2, 50.0])
    pen = np.asarray(relaxed_barrier(h, 0.0, 5.0))
    assert np.all(pen == 0.0), pen


def test_ipm_enforces_active_cone_with_duals(pushed):
    """From the soft warm start whose binding cone is VIOLATED, the IPM
    restores strict feasibility with converging duals and central-path
    complementarity, at a bounded force adjustment."""
    iface, refs, t_nodes, x0, soft = pushed
    flags = np.asarray(refs.contact_flags) > 0.5
    g_soft = _cone_values(iface, iface.settings, soft.u_traj)
    assert g_soft[flags].min() < -2.0, (
        f"scenario no longer cone-active: soft gmin {g_soft[flags].min():.2f}"
    )

    from bipedal_nmpc.solver.sqp import sqp_solve

    settings = dataclasses.replace(
        iface.settings, cone="ipm", sqp_iterations=12,
        ipm_mu_init=1e-2, ipm_mu_decay=0.3, ipm_mu_target=1e-4,
        ipm_dual_step_from_primal=False,
    )
    sol = sqp_solve(
        iface.model, iface.info, settings, iface.Q, iface.R,
        refs, t_nodes, x0, soft.x_traj, soft.u_traj,
    )
    g = _cone_values(iface, iface.settings, sol.u_traj)
    s = np.asarray(sol.cone_slack)
    lam = np.asarray(sol.cone_dual)
    # strict feasibility on every stance cone (soft left -7.06)
    assert g[flags].min() > -1e-3, float(g[flags].min())
    # duals: positive everywhere, and genuinely ACTIVE on the binding cones
    assert np.all(lam > 0) and np.all(s > 0)
    binding = flags & (g < 0.5)
    assert np.any(binding) and lam[binding].max() > 1e-2, (
        float(lam[binding].max()) if np.any(binding) else "no binding cone"
    )
    # central path: complementarity collapses toward mu_target
    comp_med = float(np.median((s * lam)[flags]))
    assert comp_med < 50 * settings.ipm_mu_target, comp_med
    # dynamics stay converged and the adjustment from soft is bounded
    assert float(sol.defect_norm) < 1e-3, float(sol.defect_norm)
    dF = np.abs(np.asarray(sol.u_traj)[:, :12] - np.asarray(soft.u_traj)[:, :12])
    assert dF.max() < 20.0, f"force adjustment {dF.max():.1f} N"


def test_ipm_inert_when_cones_inactive(pushed):
    """On a feasible warm start (no binding cone) the IPM must be a no-op
    to solver precision — the slack/dual machinery adds nothing when the
    constraint is inactive."""
    iface, refs, t_nodes, x0, _ = pushed
    from bipedal_nmpc.solver.sqp import (
        build_refs,  # noqa: F401 (signature parity)
        initial_trajectory,
        sqp_solve,
    )

    x0_mild = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0_mild, iface.settings.num_intervals + 1)
    soft = sqp_solve(
        iface.model, iface.info,
        dataclasses.replace(iface.settings, cone="soft", sqp_iterations=6),
        iface.Q, iface.R, refs, t_nodes, x0_mild, xs, us,
    )
    settings = dataclasses.replace(
        iface.settings, cone="ipm", sqp_iterations=6,
        ipm_dual_step_from_primal=False,
    )
    sol = sqp_solve(
        iface.model, iface.info, settings, iface.Q, iface.R,
        refs, t_nodes, x0_mild, soft.x_traj, soft.u_traj,
    )
    flags = np.asarray(refs.contact_flags) > 0.5
    g = _cone_values(iface, iface.settings, sol.u_traj)
    assert g[flags].min() > 1.0  # comfortably interior
    dF = np.abs(np.asarray(sol.u_traj)[:, :12] - np.asarray(soft.u_traj)[:, :12])
    assert dF.max() < 1.0, f"IPM perturbed an inactive-cone solution by {dF.max():.2f} N"


def test_ipm_settings_bound_from_reference_config():
    """make_interface_for wires the parsed task.info ipm block onto the
    primal-dual knobs (central-path schedule + fraction-to-boundary)."""
    _require_h1()
    from bipedal_nmpc.interface import make_interface_for

    iface = make_interface_for("h1")
    st = iface.settings
    ipm = iface.task.ipm
    assert st.ipm_mu_target == ipm.target_barrier
    assert st.ipm_mu_decay == ipm.decrease_factor
    assert st.ipm_fraction_to_boundary == ipm.fraction_to_boundary
    assert st.ipm_mu_init >= st.ipm_mu_target
