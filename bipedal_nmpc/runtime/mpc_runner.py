"""MPC runner: warm-started replanning loop around the jitted SQP.

Host-side orchestration replacing the reference's MPC thread + MPC_MRT
handoff (BipedalController.cpp:319-352): it owns the reference manager, the
previous solution (warm start), and a single compiled solve.  The compiled
function is shape-stable across replans — gait changes arrive as new device
tables, not new programs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..interface import RobotInterface
from ..reference.manager import ReferenceManager
from ..solver.sqp import (
    SqpSolution,
    build_refs,
    initial_trajectory,
    sqp_solve,
)
from ..utils.precision import default_matmul_precision
from ..utils.timing import RepeatedTimer


def capture_dq_from_state(cap, nj: int, x, x_ref, gait_table=None, t0=None):
    """(2, nj) swing-leg joint-reference offsets from the measured lateral
    error (config.loader.CaptureConfig semantics): rotate the world-frame
    base-position / CoM-velocity errors into the body frame by the measured
    yaw, form dq = sign * clip(kp e_y + kv edot_y, +-max_offset), and place
    it on each leg's hip-roll slot.  Pure jnp (jittable inside the fused
    replan).

    cap.touchdown_sync (with gait_table/t0 supplied): instead of the
    instantaneous errors, each leg's (e_y, edot_y) are LIPM-propagated to
    that leg's NEXT TOUCHDOWN (gait/mode_schedule.py
    next_touchdown_per_leg — the LegLogic timing query):
        e(dt) = e cosh(w dt) + (edot/w) sinh(w dt),  w = sqrt(g/z_ref)
    so the bias steers the foot toward where the capture point will BE when
    the foot lands, rather than chasing the intra-swing phase of a lateral
    oscillation (the documented OpenLoong rocking-mode lead)."""
    yaw = x[9]
    s, c = jnp.sin(yaw), jnp.cos(yaw)
    pe = x[6:8] - x_ref[6:8]  # world base-position error
    ve = x[0:2] - x_ref[0:2]  # world CoM-velocity error (h/m)
    e_y = -s * pe[0] + c * pe[1]  # body-frame lateral components
    edot_y = -s * ve[0] + c * ve[1]
    # soft deadband: capture is a recovery reflex — exactly zero in nominal
    # locomotion, full-gain beyond the threshold (CaptureConfig docstring)
    dz = lambda v, db: jnp.sign(v) * jnp.maximum(jnp.abs(v) - db, 0.0)

    def _dq(e, edot):
        return cap.sign * jnp.clip(
            cap.kp * dz(e, cap.pos_deadband) + cap.kv * dz(edot, cap.vel_deadband),
            -cap.max_offset,
            cap.max_offset,
        )

    if getattr(cap, "touchdown_sync", False) and gait_table is not None:
        w = jnp.sqrt(9.81 / jnp.maximum(x_ref[8], 0.3))
        # per-leg horizon to touchdown, capped at one swing's worth (past
        # that the LIPM extrapolation is meaningless)
        dt_td = jnp.clip(gait_table.next_touchdown_per_leg(t0) - t0, 0.0, 0.6)
        ch, sh = jnp.cosh(w * dt_td), jnp.sinh(w * dt_td)  # (2,)
        e_td = e_y * ch + (edot_y / w) * sh
        edot_td = e_y * w * sh + edot_y * ch
        dq_legs = _dq(e_td, edot_td)  # (2,)
        z = jnp.zeros(nj, x.dtype)
        return jnp.stack(
            [z.at[cap.left_index].set(dq_legs[0]), z.at[cap.right_index].set(dq_legs[1])]
        )
    dq = _dq(e_y, edot_y)
    z = jnp.zeros(nj, x.dtype)
    return jnp.stack([z.at[cap.left_index].set(dq), z.at[cap.right_index].set(dq)])


def make_capture_hook(cap, nj: int):
    """(dq_fn, decay) pair shared by the host fused replan and the on-device
    batch loop.  dq_fn(gait, target, t_nodes, x_obs) returns the (2, nj)
    swing joint-reference offsets, or None when no captureStepping block is
    configured (the hook traces out as dead code).  The gait table feeds
    the touchdownSync timing query."""

    def dq_fn(gait, target, t_nodes, x_obs):
        if cap is None:
            return None
        return capture_dq_from_state(
            cap, nj, x_obs, target.state_at(t_nodes[0]), gait, t_nodes[0]
        )

    decay = cap.decay if (cap is not None and cap.decay > 0) else None
    ws = cap.weight_shift if (cap is not None and getattr(cap, "weight_shift", 0.0) > 0) else None
    return dq_fn, decay, ws


class MpcRunner:
    """`solver` selects the replan backend: "sqp" (SqpMpc analogue, default)
    or "ilqr" (GaussNewtonDDP_MPC / BipedalRobotDdpMpcNode.cpp:70-72 analogue;
    AL-iLQR single shooting, warm-started on the previous input trajectory).
    `ddp_iterations` overrides task.info ddp.maxNumIterations for the ilqr
    path (RTI-style replanning wants a small fixed count)."""

    def __init__(
        self,
        iface: RobotInterface,
        reference_manager: ReferenceManager | None = None,
        solver: str = "sqp",
        ddp_iterations: int | None = None,
        ddp_penalty: float | None = None,
    ):
        self.iface = iface
        self.rm = reference_manager or iface.make_reference_manager()
        self.last_solution: SqpSolution | None = None
        self.last_frozen = None
        self.timer = RepeatedTimer("mpc")
        self.solver = solver
        model, info, settings = iface.model, iface.info, iface.settings
        Q, R = iface.Q, iface.R

        if solver == "sqp":

            @jax.jit
            def _solve(refs, t_nodes, x_init, xs, us):
                return sqp_solve(model, info, settings, Q, R, refs, t_nodes, x_init, xs, us)

        elif solver == "ilqr":
            from ..solver.ddp import DdpSettings, ilqr_solve

            c = iface.task.ddp
            # AL trot replanning needs rho ~1e2: the task.info value (20)
            # under-penalizes swing rows and the warm-start chain drifts
            # infeasible; rho >= 1e3 makes the penalized backward pass so
            # stiff the nonlinear rollout diverges (measured sweep).  AL
            # state is NOT carried across replans: the per-iterate
            # first-order multiplier updates over-accumulate when chained
            # (measured: eq diverges within 4 replans), whereas fresh
            # multipliers per solve converge — matching the reference's
            # per-solve constraint-penalty semantics.
            dcfg = DdpSettings(
                iterations=int(ddp_iterations if ddp_iterations is not None else c.max_iterations),
                constraint_penalty=float(
                    ddp_penalty if ddp_penalty is not None else max(c.constraint_penalty, 100.0)
                ),
                penalty_increase_rate=float(c.penalty_increase_rate),
                # ddp.strategy flows through (LINE_SEARCH in every shipped
                # task.info, so this is behavior-preserving); minRelCost is
                # opt-in via DdpSettings — the rolling-loop tests pin the
                # fixed-iteration behavior
                strategy=c.strategy,
            )

            @jax.jit
            def _solve(refs, t_nodes, x_init, xs, us):
                # xs seeds iteration 0's linearization only (cold start:
                # initial_trajectory's constant state; warm: shifted previous
                # solution); the accepted states come from nonlinear rollouts.
                return ilqr_solve(
                    model, info, settings, dcfg, Q, R, refs, t_nodes, x_init, us,
                    x_warm=xs,
                )

        else:
            raise ValueError(f"unknown solver {solver!r} (expected 'sqp' or 'ilqr')")
        self._solve = _solve

        # The WHOLE replan — node-reference lookup, warm-start interpolation,
        # solve — as ONE compiled dispatch.  Running build_refs /
        # warm_start_from_solution eagerly costs dozens of op round trips per
        # replan.
        num_nodes = settings.num_intervals + 1
        from ..solver.sqp import warm_start_trajectories

        cap = getattr(iface.task, "capture", None)
        _capture_dq, decay, wshift = make_capture_hook(cap, info.nj)

        # Full-f32 matmuls, never reduced-precision passes (utils/precision.py).
        _mm = getattr(iface.task, "matmul_precision", None)

        @jax.jit
        def _replan_cold(gait, swing, target, t_nodes, x_init):
            with default_matmul_precision(_mm):
                dq = _capture_dq(gait, target, t_nodes, x_init)
                refs = build_refs(info, gait, swing, target, t_nodes, dq, decay, wshift)
                xs, us = initial_trajectory(info, refs, x_init, num_nodes)
                return _solve(refs, t_nodes, x_init, xs, us)

        @jax.jit
        def _replan_warm(gait, swing, target, t_nodes, x_init, prev_t, prev_xs, prev_us):
            with default_matmul_precision(_mm):
                dq = _capture_dq(gait, target, t_nodes, x_init)
                refs = build_refs(info, gait, swing, target, t_nodes, dq, decay, wshift)
                xs, us = warm_start_trajectories(prev_t, prev_xs, prev_us, t_nodes)
                return _solve(refs, t_nodes, x_init, xs, us)

        self._replan_cold = _replan_cold
        self._replan_warm = _replan_warm

    def reset(self):
        self.last_solution = None
        self.last_frozen = None

    # command-channel sink (CommandRouter): same surface as AsyncMpcRunner
    def set_gait(self, template, start_time: float) -> None:
        self.rm.set_gait(template, start_time)

    def set_target(self, target) -> None:
        self.rm.set_target(target)

    def advance(self, t: float, x_measured) -> SqpSolution:
        """One replan (MPC_MRT_Interface::advanceMpc equivalent)."""
        return self.advance_frozen(t, x_measured, self.rm.freeze(t))

    def advance_frozen(self, t: float, x_measured, frozen) -> SqpSolution:
        """Solve against an already-frozen reference set (the async worker
        freezes under the gait lock, then solves outside it).  One device
        dispatch: references, warm start, and solve are fused."""
        self.last_frozen = frozen
        t_nodes = jnp.asarray(frozen.t_nodes)
        with self.timer:
            if self.last_solution is None:
                sol = self._replan_cold(
                    frozen.gait, frozen.swing, frozen.target, t_nodes, x_measured
                )
            else:
                prev = self.last_solution
                sol = self._replan_warm(
                    frozen.gait, frozen.swing, frozen.target, t_nodes, x_measured,
                    prev.t_nodes, prev.x_traj, prev.u_traj,
                )
            jax.block_until_ready(sol.x_traj)
        self.last_solution = sol
        return sol
