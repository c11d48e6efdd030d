"""Multiple-shooting Gauss-Newton SQP (OCS2 SqpMpc equivalent).

One jitted ``sqp_solve`` does: per-node linearization (vmap over the horizon),
the equality-constrained Riccati sweep (solver/riccati.py), and a parallel
merit line search (all step-size candidates evaluated in one vmap instead of
sequential backtracking).  Default ``sqp_iterations=1`` matches the
reference's real-time iteration scheme (task.info sqp.sqpIteration 1).

Everything is static-shape: mode switching enters only through per-node
reference tables, so the same compiled solve serves every gait, and a batch
axis of independent scenarios can be vmapped/pjitted on top.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.linearize import linearize_node_structured, node_eval
from ..ocp.problem import (
    NodeRefs,
    OcpSettings,
    discrete_dynamics,
    equality_residual,
    make_node_refs,
    node_cost,
    weight_compensating_input,
)
from ..backend import select_backends
from .riccati import solve_lqr

# Filter-linesearch bands on the squared constraint violation (ISE), matching
# the reference solver settings (task.info sqp.g_max 1e-2 / g_min 1e-6).
_G_MAX = 1e-2
_G_MIN = 1e-6


class SqpSolution(NamedTuple):
    """PrimalSolution equivalent: policy nodes + feedback gains."""

    t_nodes: jnp.ndarray  # (N+1,)
    x_traj: jnp.ndarray  # (N+1, nx)
    u_traj: jnp.ndarray  # (N, nu)
    K: jnp.ndarray  # (N, nu, nx) feedback gains
    cost: jnp.ndarray  # () achieved merit cost term
    defect_norm: jnp.ndarray  # () l1 dynamics defect
    eq_norm: jnp.ndarray  # () l1 equality residual
    step_size: jnp.ndarray  # () accepted line-search step
    # cone="ipm" extras (None otherwise): per-node friction-cone slack and
    # dual iterates at the returned primal point
    cone_slack: jnp.ndarray | None = None  # (N, nc)
    cone_dual: jnp.ndarray | None = None  # (N, nc)


def eq_mask_from_flags(contact_flags):
    """(..., 4) flags -> (..., 16) active-row mask: the 12 velocity/force rows
    are always active; the 4 normal-velocity rows only during swing."""
    ones = jnp.ones(contact_flags.shape[:-1] + (12,))
    return jnp.concatenate([ones, 1.0 - contact_flags], axis=-1)


def _merit(model, info, settings, Q, R, xs, us, refs: NodeRefs):
    """(cost, l1 defect, l1 equality residual) over the horizon."""

    def per_node(x, u, x_next, ref):
        c = ref.dt * node_cost(model, info, settings, Q, R, x, u, ref)
        defect = discrete_dynamics(model, info, settings, x, u, ref.dt) - x_next
        e = equality_residual(model, info, settings, x, u, ref)
        mask = eq_mask_from_flags(ref.contact_flags)
        return c, jnp.sum(jnp.abs(defect)), jnp.sum(jnp.abs(mask * e))

    costs, defects, eqs = jax.vmap(per_node)(xs[:-1], us, xs[1:], refs)
    return jnp.sum(costs), jnp.sum(defects), jnp.sum(eqs)


def _performance(model, info, settings, Q, R, xs, us, refs: NodeRefs):
    """(cost, squared-violation ISE, l1 defect, l1 eq) in one horizon pass
    (OCS2 PerformanceIndex: dynamicsViolationSSE + equalityConstraintsSSE;
    the l1 norms feed the solution diagnostics without a second pass)."""

    def per_node(x, u, x_next, ref):
        c, defect, e = node_eval(model, info, settings, Q, R, x, u, x_next, ref)
        return (
            c,
            jnp.sum(defect**2) + jnp.sum(e**2),
            jnp.sum(jnp.abs(defect)),
            jnp.sum(jnp.abs(e)),
        )

    costs, viols, d1, e1 = jax.vmap(per_node)(xs[:-1], us, xs[1:], refs)
    return jnp.sum(costs), jnp.sum(viols), jnp.sum(d1), jnp.sum(e1)


def _filter_accept(cost_base, viol_base, cost_step, viol_step):
    """OCS2 FilterLinesearch acceptance: infeasible iterates must reduce
    violation; near-feasible steps must reduce cost; in between either —
    and a step from a feasible base may NEVER leave the g_max band (the
    knob's meaning: max constraint violation allowed during linesearch).

    Without the band cap, a large reference discontinuity (e.g. walk ->
    stop-and-stance) lets the full Gauss-Newton step trade a huge dynamics
    defect for its cost reduction: measured at the envelope test's stance
    switch-back, alpha=1 was accepted at defect ~1.2 from a 6e-4-feasible
    base, the published policy commanded flight, and the robot fell.  With
    the cap those candidates reject and a smaller alpha (or the alpha=0
    fallback) keeps the iterates inside the band."""
    infeasible = viol_base > _G_MAX
    blowup = viol_step > _G_MAX  # leaving the band from a feasible base
    both_feasible = jnp.logical_and(viol_step < _G_MIN, viol_base < _G_MAX)
    reduce_viol = viol_step < (1.0 - 1e-3) * viol_base
    reduce_cost = cost_step < cost_base - 1e-6 * jnp.abs(cost_base)
    return jnp.where(
        infeasible,
        reduce_viol,
        jnp.where(
            blowup,
            jnp.asarray(False),
            jnp.where(both_feasible, reduce_cost, jnp.logical_or(reduce_cost, reduce_viol)),
        ),
    )


def sqp_solve(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    refs: NodeRefs,  # stacked over N (one per interval, at node times)
    t_nodes,  # (N+1,)
    x_init,  # (nx,) measured initial state
    x_warm,  # (N+1, nx) warm-start state trajectory
    u_warm,  # (N, nu)
    cone_warm=None,  # cone="ipm": optional (s, lam) warm start, (N, nc) each
) -> SqpSolution:
    """Run `settings.sqp_iterations` Gauss-Newton iterations."""

    xs, us = x_warm, u_warm
    # the initial state is a hard parameter: pin node 0
    xs = xs.at[0].set(x_init)

    def _iter_settings(it: int):
        """cone="hard": interior-point continuation — shrink the barrier's mu
        and relaxed switch point delta geometrically per (statically
        unrolled) SQP iteration, so late iterations solve an almost-true log
        barrier and the result respects the cone to ~cone_delta_final.
        cone="ipm": the cone enters through the primal-dual condensed terms
        added to the stage quadratics below, so the soft barrier is disabled
        (barrier_mu=0 zeroes every relaxed-barrier contribution)."""
        import dataclasses as _dc

        if settings.cone == "ipm":
            return _dc.replace(settings, barrier_mu=0.0)
        if settings.cone != "hard":
            return settings

        decay = settings.cone_mu_decay**it
        return _dc.replace(
            settings,
            barrier_mu=max(settings.barrier_mu * decay, settings.cone_mu_final),
            barrier_delta=max(settings.barrier_delta * decay, settings.cone_delta_final),
        )

    def _lin_fn(settings_it):
        return jax.vmap(
            lambda x, u, xn, ref: linearize_node_structured(
                model, info, settings_it, Q, R, x, u, xn, ref
            )
        )

    step_size = jnp.asarray(1.0)
    masks = eq_mask_from_flags(refs.contact_flags)
    settings = select_backends(settings)
    if settings.riccati == "parallel":
        from .parallel_riccati import solve_lqr_parallel

        lqr = lambda n, m, dx0: solve_lqr_parallel(n, m, dx0, settings.riccati_penalty)
    elif settings.riccati == "triton":
        from .riccati import solve_lqr_triton

        lqr = solve_lqr_triton
    elif settings.riccati == "parallel_sqrt":
        from .parallel_riccati import solve_lqr_parallel_sqrt

        lqr = lambda n, m, dx0: solve_lqr_parallel_sqrt(n, m, dx0, settings.riccati_penalty)
    else:
        lqr = solve_lqr
    # --- cone="ipm": primal-dual slack/dual state (OCS2 ipm role).  Per
    # node and stance cone: s > 0 slack, lam > 0 dual, central path
    # s*lam -> mu with mu marching ipm_mu_init -> ipm_mu_target across the
    # (statically unrolled) iterations.  All masking is static-shape: swing
    # cones carry benign (1, mu) iterates and zero condensed weight.
    ipm = settings.cone == "ipm"
    if ipm:
        from ..ocp.problem import friction_cone_grads_u, friction_cone_values

        cone_act = refs.contact_flags > 0.5  # (N, nc)
        mu_ipm = settings.ipm_mu_init
        if cone_warm is not None:
            s_ipm, lam_ipm = cone_warm
        else:
            g_w = jax.vmap(lambda u: friction_cone_values(settings, u, info))(us)
            s_ipm = jnp.where(cone_act, jnp.maximum(g_w, 1e-2), 1.0)
            lam_ipm = jnp.where(cone_act, mu_ipm / s_ipm, mu_ipm)
    else:
        s_ipm = lam_ipm = None

    gains = None
    for _it in range(settings.sqp_iterations):
        settings_it = _iter_settings(_it)
        nodes = _lin_fn(settings_it)(xs[:-1], us, xs[1:], refs)
        if ipm:
            # condensed primal-dual Newton terms on the stage quadratics:
            #   Quu += sum_j w_j (lam_j/s_j) G_j G_j^T
            #   qu  -= sum_j w_j (mu/s_j - (lam_j/s_j)(g_j - s_j)) G_j
            # (dt-scaled like every other stage cost term)
            g_ipm = jax.vmap(lambda u: friction_cone_values(settings, u, info))(us)
            G_ipm = jax.vmap(lambda u: friction_cone_grads_u(settings, u, info))(us)
            w_ipm = refs.dt[:, None] * refs.contact_flags  # (N, nc)
            sig = lam_ipm / s_ipm
            Quu_pd = jnp.einsum("nc,ncu,ncv->nuv", w_ipm * sig, G_ipm, G_ipm)
            qu_pd = -jnp.einsum(
                "nc,ncu->nu",
                w_ipm * (mu_ipm / s_ipm - sig * (g_ipm - s_ipm)),
                G_ipm,
            )
            nodes = nodes._replace(Quu=nodes.Quu + Quu_pd, qu=nodes.qu + qu_pd)
        sol = lqr(nodes, masks, dx0=jnp.zeros_like(x_init))
        gains = sol.K

        if len(settings.linesearch_alphas) == 0:
            # Pure RTI: always take the full Newton step and skip the merit
            # evaluation entirely (the acados-style real-time iteration).
            # Safety envelope vs the filter: tools/alpha_sweep.py.  Diagnostics
            # (cost/defect/eq) are those of the PRE-step point — the data
            # the linearization already holds; across chained warm RTI
            # solves they lag one replan, converging to the same value.
            if ipm:
                raise NotImplementedError(
                    "cone='ipm' needs linesearch candidates for its "
                    "fraction-to-boundary cap; use a non-empty "
                    "linesearch_alphas"
                )
            xs = xs + sol.dx
            us = us + sol.du
            step_size = jnp.asarray(1.0)
            e_masked = masks * nodes.e
            cost = jnp.sum(nodes.cost)
            defect = jnp.sum(jnp.abs(nodes.c))
            eq = jnp.sum(jnp.abs(e_masked))
            continue

        alphas = jnp.asarray(settings.linesearch_alphas)
        if ipm:
            # slack/dual Newton directions recovered from du, then the
            # fraction-to-boundary rule caps every primal step candidate
            ds_ipm = jnp.einsum("ncu,nu->nc", G_ipm, sol.du) + (g_ipm - s_ipm)
            dlam_ipm = (mu_ipm - s_ipm * lam_ipm) / s_ipm - sig * ds_ipm
            frac = settings.ipm_fraction_to_boundary

            def _max_step(v, dv):
                r = jnp.where(
                    jnp.logical_and(cone_act, dv < 0),
                    -frac * v / jnp.minimum(dv, -1e-12),
                    jnp.inf,
                )
                return jnp.minimum(1.0, jnp.min(r))

            a_s_max = _max_step(s_ipm, ds_ipm)
            a_lam_max = _max_step(lam_ipm, dlam_ipm)
            alphas = jnp.minimum(alphas, a_s_max)

            def _cone_viol(a):
                """Primal cone residual ||g(u_a) - s_a||^2 on active cones —
                the IPM term of the filter's violation channel.  Without it
                a feasibility-restoring step from a cost-converged warm
                start is always rejected as a cost increase (measured: the
                filter pins step_size to 0 and the cone stays violated)."""
                g_a = jax.vmap(lambda u: friction_cone_values(settings, u, info))(
                    us + a * sol.du
                )
                s_a = s_ipm + a * ds_ipm
                return jnp.sum(refs.contact_flags * (g_a - s_a) ** 2)

        def try_alpha(a):
            xs_a = xs + a * sol.dx
            us_a = us + a * sol.du
            return _performance(model, info, settings_it, Q, R, xs_a, us_a, refs)

        costs_a, viols_a, d1_a, e1_a = jax.vmap(try_alpha)(alphas)
        # alpha = 0 baseline from the node data the linearization already holds
        e_masked = masks * nodes.e
        cost0 = jnp.sum(nodes.cost)
        viol0 = jnp.sum(nodes.c**2) + jnp.sum(e_masked**2)
        if ipm:
            viols_a = viols_a + jax.vmap(_cone_viol)(alphas)
            viol0 = viol0 + jnp.sum(refs.contact_flags * (g_ipm - s_ipm) ** 2)
        d1_0 = jnp.sum(jnp.abs(nodes.c))
        e1_0 = jnp.sum(jnp.abs(e_masked))
        accepted = _filter_accept(cost0, viol0, costs_a, viols_a)
        # largest accepted alpha (alphas sorted descending); fall back to 0
        idx = jnp.argmax(accepted)
        any_ok = jnp.any(accepted)
        step_size = jnp.where(any_ok, alphas[idx], 0.0)
        xs = xs + step_size * sol.dx
        us = us + step_size * sol.du
        cost = jnp.where(any_ok, costs_a[idx], cost0)
        defect = jnp.where(any_ok, d1_a[idx], d1_0)
        eq = jnp.where(any_ok, e1_a[idx], e1_0)
        if ipm:
            a_dual = (
                step_size
                if settings.ipm_dual_step_from_primal
                else jnp.where(any_ok, a_lam_max, 0.0)
            )
            s_ipm = jnp.maximum(s_ipm + step_size * ds_ipm, 1e-10)
            lam_ipm = jnp.maximum(lam_ipm + a_dual * dlam_ipm, 1e-10)
            mu_ipm = max(settings.ipm_mu_target, mu_ipm * settings.ipm_mu_decay)
    # Feedback gains from the last QP (real-time-iteration practice: OCS2
    # likewise publishes the gains of the QP it just solved).
    return SqpSolution(
        t_nodes=t_nodes,
        x_traj=xs,
        u_traj=us,
        K=gains,
        cost=cost,
        defect_norm=defect,
        eq_norm=eq,
        step_size=step_size,
        cone_slack=s_ipm,
        cone_dual=lam_ipm,
    )


def build_refs(info: CentroidalModelInfo, gait_table, swing_table, target_table, t_nodes,
               dq_swing=None, dq_decay: float | None = None,
               weight_shift: float | None = None):
    """Stacked NodeRefs for each interval (vmap over node times).

    dq_swing: optional (2, nj) joint-reference offsets (row 0 = left leg,
    row 1 = right leg) applied to x_nom's joint block at every node where
    that leg is in swing — the capture-stepping hook (config.loader
    CaptureConfig): touchdown placement is steered by biasing the swing-leg
    hip-roll reference, while stance-node references stay untouched.
    dq_decay: optional time constant [s]; the offset decays exp(-(t-t0)/tau)
    along the horizon, so only the imminent touchdown is steered by the
    *current* error — a constant offset a full horizon ahead over-corrects
    errors that will be gone by then (measured limit cycle on OpenLoong).
    weight_shift: optional amplitude [m] of a PHASE-LOCKED base-y reference
    offset toward the single-support stance foot (CaptureConfig
    weightShift): each node's base-xy reference moves laterally over the
    foot that carries the robot in that node's mode, pre-loading the
    lateral CoM transfer the gait needs instead of leaving it to feedback
    (the documented OpenLoong weight-shift lead)."""
    dts = t_nodes[1:] - t_nodes[:-1]
    t0 = t_nodes[0]

    def mk(t, dt):
        r = make_node_refs(info, gait_table, swing_table, target_table, t, dt)
        f = r.contact_flags  # [l_toe, l_heel, r_toe, r_heel]
        if dq_swing is not None:
            left_swing = 1.0 - jnp.maximum(f[0], f[1])
            right_swing = 1.0 - jnp.maximum(f[2], f[3])
            scale = 1.0 if dq_decay is None else jnp.exp(-jnp.maximum(t - t0, 0.0) / dq_decay)
            x_nom = r.x_nom.at[12:].add(
                scale * (left_swing * dq_swing[0] + right_swing * dq_swing[1])
            )
            r = r._replace(x_nom=x_nom)
        if weight_shift is not None:
            # +1 left single support, -1 right, 0 double/flight; body +y is
            # toward the left foot, rotated to world by the node's yaw ref
            side = jnp.maximum(f[0], f[1]) - jnp.maximum(f[2], f[3])
            yaw = r.x_nom[9]
            dy = weight_shift * side
            x_nom = r.x_nom.at[6].add(-jnp.sin(yaw) * dy).at[7].add(jnp.cos(yaw) * dy)
            r = r._replace(x_nom=x_nom)
        return r

    return jax.vmap(mk)(t_nodes[:-1], dts)


def initial_trajectory(info: CentroidalModelInfo, refs: NodeRefs, x_init, num_nodes: int):
    """Cold-start rollout matching the reference Initializer
    (BipedalRobotInitializer.cpp:42-63): state held constant, input =
    weight-compensating forces for the node's contact mode."""
    xs = jnp.tile(x_init[None], (num_nodes, 1))
    us = jax.vmap(lambda f: weight_compensating_input(info, f, info.input_dim))(
        refs.contact_flags
    )
    return xs, us


def warm_start_trajectories(prev_t_nodes, prev_xs, prev_us, t_nodes):
    """Shift (x, u) trajectories from their own node grid onto a new one by
    linear interpolation (pure jnp — usable inside jitted replan loops)."""

    def interp_rows(times, rows, t):
        idx = jnp.clip(jnp.searchsorted(times, t, side="right"), 1, rows.shape[0] - 1)
        t0, t1 = times[idx - 1], times[idx]
        alpha = jnp.clip((t - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)
        return rows[idx - 1] * (1 - alpha) + rows[idx] * alpha

    xs = jax.vmap(lambda t: interp_rows(prev_t_nodes, prev_xs, t))(t_nodes)
    us = jax.vmap(lambda t: interp_rows(prev_t_nodes[:-1], prev_us, t))(t_nodes[:-1])
    return xs, us


def warm_start_from_solution(prev: SqpSolution, t_nodes):
    """Shift the previous solution onto a new time grid (MPC warm start;
    replaces OCS2's internal trajectory re-initialization, mpc.coldStart=false)."""
    return warm_start_trajectories(prev.t_nodes, prev.x_traj, prev.u_traj, t_nodes)
