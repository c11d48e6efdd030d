"""iLQR / Gauss-Newton DDP solver path.

The reference offers GaussNewtonDDP_MPC (algorithm ILQR) as an alternative to
the SQP node (BipedalRobotDdpMpcNode.cpp:59-100; ddp block of task.info:119-156).
This is the JAX equivalent, sharing the structured linearization with
the SQP path:

- single shooting: the forward pass is a *nonlinear* rollout under the
  time-varying affine feedback policy (lax.scan), so dynamics defects vanish
  by construction;
- state-input equality constraints enter the backward pass through the same
  **constrained stage KKT** the SQP Riccati uses (masked C/D/e rows solved
  exactly per stage) — the analogue of OCS2 DDP's state-input-equality
  *projection*.  A pure augmented-Lagrangian backward pass (penalty-folded
  quadratics, `constrained_backward=False`) was the first implementation and
  is kept as a research path: it refines a near-feasible iterate fine, but in
  a rolling-time MPC loop its O(1/rho) constraint slack lets the stance feet
  creep every replan — measured on the H1 trot dummy loop the base sinks
  ~0.5 m over 0.7 s and collapses, while the projected backward pass holds
  eq-violation at SQP levels.  The AL *merit* (multiplier estimates + rho)
  is still what accepts/rejects rollouts in both modes;
- line search over feedback-rollout step sizes, all candidates in one vmap.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.linearize import linearize_node_structured, node_eval
from ..ocp.problem import NodeRefs, OcpSettings, discrete_dynamics
from .riccati import solve_lqr
from .sqp import SqpSolution, eq_mask_from_flags


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    iterations: int = 10  # ddp.maxNumIterations (per replan; RTI uses 1)
    constraint_penalty: float = 20.0  # ddp.constraintPenaltyInitialValue
    penalty_increase_rate: float = 2.0  # ddp.constraintPenaltyIncreaseRate
    # lineSearch minStepLength 1e-2 / maxStepLength 1.0 (task.info:150-152)
    alphas: tuple = (1.0, 0.3, 0.1, 0.03, 0.01)
    # Levenberg-Marquardt Quu shift (hessianCorrectionStrategy DIAGONAL_SHIFT).
    # Keep SMALL: 1.0 over-damps against the task-scaled R (measured on the H1
    # trot warm chain: per-iteration cost decrease stalls at ~0.5%/iter and the
    # horizon tail never recovers from the warm-shift sag, sinking the MPC
    # loop; 0.01 converges to the SQP solution in ~8 iterations)
    hessian_shift: float = 0.01
    # augmented Lagrangian: multiplier updates on accepted iterates; rho
    # escalates only when an update fails to cut ||e||^2 by this factor
    multiplier_updates: bool = True
    violation_decrease_factor: float = 0.25
    max_penalty: float = 1e6
    # equality constraints in the backward pass: True = constrained stage KKT
    # (OCS2 projection analogue; holds contacts in rolling-time MPC loops),
    # False = penalty-folded quadratics (AL research path; creeps in loops)
    constrained_backward: bool = True
    # search strategy (ddp.strategy, task.info:147): "line_search" = the
    # alphas ladder above; "levenberg_marquardt" = OCS2's LM alternative —
    # full steps only, with an ADAPTIVE Quu diagonal shift carried across
    # iterations (accepted rollout: shift shrinks toward hessian_shift;
    # rejected: shift grows and the next backward pass is more damped,
    # the classic trust-region-like LM schedule)
    strategy: str = "line_search"
    lm_shrink: float = 0.5
    lm_grow: float = 4.0
    lm_shift_max: float = 1e3
    # ddp.minRelCost (task.info:126): once an accepted iterate improves the
    # AL merit by less than this RELATIVE amount, further iterations freeze
    # (statically-unrolled analogue of OCS2's early termination).  0.0 =
    # never freeze (backward-compatible default; opt in from config)
    min_rel_cost: float = 0.0


def _penalized_nodes(nodes, masks, rho, lam):
    """Fold the masked equality constraints into the cost quadratics
    (augmented-Lagrangian linear term: C^T/D^T (lam + rho e))."""
    D = masks[..., None] * nodes.D
    C = masks[..., None] * nodes.C
    e = masks * nodes.e
    g = lam + rho * e
    bt = lambda M: M.swapaxes(-1, -2)
    return nodes._replace(
        Qxx=nodes.Qxx + rho * bt(C) @ C,
        Quu=nodes.Quu + rho * bt(D) @ D,
        Qux=nodes.Qux + rho * bt(D) @ C,
        qx=nodes.qx + jnp.einsum("...ij,...i->...j", C, g),
        qu=nodes.qu + jnp.einsum("...ij,...i->...j", D, g),
        C=jnp.zeros_like(nodes.C),
        D=jnp.zeros_like(nodes.D),
        e=jnp.zeros_like(nodes.e),
    )


def _rollout(model, info, settings, refs, x_init, x_bar, u_bar, K, k_ff, alpha):
    """Closed-loop nonlinear rollout: u = u_bar + alpha k - K (x - x_bar)."""

    def step(x, inp):
        xb, ub, Kk, kk, ref = inp
        u = ub - alpha * kk - Kk @ (x - xb)
        x_next = discrete_dynamics(model, info, settings, x, u, ref.dt)
        return x_next, (x, u)

    x_last, (xs, us) = jax.lax.scan(step, x_init, (x_bar[:-1], u_bar, K, k_ff, refs))
    return jnp.concatenate([xs, x_last[None]], axis=0), us


def ilqr_solve(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    ddp: DdpSettings,
    Q,
    R,
    refs: NodeRefs,
    t_nodes,
    x_init,
    u_warm,
    x_warm=None,
    al_state=None,
    return_al_state: bool = False,
    return_history: bool = False,
):
    """AL-iLQR solve.  `al_state=(lam, rho)` optionally warm-starts the
    augmented Lagrangian (with `return_al_state` the result is
    (SqpSolution, (lam, rho))) — useful for continuing a refinement at a
    FIXED iterate.  Note MpcRunner deliberately does NOT chain this across
    replans: the per-iterate first-order multiplier updates over-accumulate
    when carried (measured divergence within 4 replans on the H1 trot);
    fresh multipliers per solve converge."""
    N = u_warm.shape[0]
    masks = eq_mask_from_flags(refs.contact_flags)

    lin_fn = jax.vmap(
        lambda x, u, xn, ref: linearize_node_structured(model, info, settings, Q, R, x, u, xn, ref)
    )
    eval_fn = jax.vmap(
        lambda x, u, xn, ref: node_eval(model, info, settings, Q, R, x, u, xn, ref)
    )

    # Initial trajectory: the previous solution's (shifted) states when warm
    # (`x_warm`), else the Initializer's constant state (BipedalRobotInitializer
    # semantics) — never an open-loop rollout: integrating a biped open-loop
    # over the horizon diverges before the first backward pass can help.
    # Iteration 0 linearizes around this (defect-carrying) trajectory —
    # exactly like the SQP warm/cold start — and its backward pass supplies
    # the stabilizing feedback for the first nonlinear rollout.  Warm states
    # matter in an RTI loop: when a contact event crosses a shooting node
    # between replans, the constant-state linearization misjudges the swing
    # rows badly enough that the forced first rollout diverges (measured:
    # eq blows up within 3 replans of the trot onset).
    zeroK = jnp.zeros((N, u_warm.shape[1], x_init.shape[0]))
    xs = jnp.tile(x_init[None], (N + 1, 1)) if x_warm is None else x_warm
    us = u_warm

    K_out = zeroK
    if al_state is None:
        rho = jnp.asarray(float(ddp.constraint_penalty))
        lam = jnp.zeros_like(masks)  # (N, ne) multipliers (masked rows stay 0)
    else:
        lam, rho = al_state
        lam = lam * masks  # re-mask: contact schedule may have shifted
    _, _, e_prev = eval_fn(xs[:-1], us, xs[1:], refs)
    viol_prev = jnp.sum(e_prev**2)
    hist = []  # per-iteration (improved, best_merit, viol, cost) when asked
    lm = ddp.strategy == "levenberg_marquardt"
    shift = jnp.asarray(float(ddp.hessian_shift))  # dynamic under LM
    done = jnp.asarray(False)  # min_rel_cost freeze
    for it in range(ddp.iterations):

        def al_merit(xs_, us_, _rho, _lam):
            c, _, e = eval_fn(xs_[:-1], us_, xs_[1:], refs)
            return jnp.sum(c) + jnp.sum(_lam * e) + 0.5 * _rho * jnp.sum(e**2)

        nodes = lin_fn(xs[:-1], us, xs[1:], refs)
        nu = u_warm.shape[1]
        it_shift = shift if lm else ddp.hessian_shift
        if ddp.constrained_backward and it > 0:
            # projected equality handling on a genuine rollout iterate
            bnodes = nodes._replace(Quu=nodes.Quu + it_shift * jnp.eye(nu)[None])
            bmasks = masks
        else:
            # iteration 0 always: the initial trajectory carries dynamics
            # defects the constrained KKT would "correct" with feedforwards
            # large enough to blow up the forced first rollout (measured:
            # instant NaN from cold start) — the soft AL backward only has to
            # produce *stabilizing feedback* here
            bnodes = _penalized_nodes(nodes, masks, rho, lam)
            bnodes = bnodes._replace(Quu=bnodes.Quu + it_shift * jnp.eye(nu)[None])
            bmasks = jnp.zeros_like(masks)
        sol = solve_lqr(bnodes, bmasks, dx0=jnp.zeros_like(x_init))
        K_out = sol.K

        # LM takes FULL steps only; damping adapts instead of the step size
        alphas = jnp.asarray((1.0,) if lm else ddp.alphas)
        xs_a, us_a = jax.vmap(
            lambda a: _rollout(model, info, settings, refs, x_init, xs, us, sol.K, sol.k, a)
        )(alphas)
        merits = jax.vmap(lambda xs_, us_: al_merit(xs_, us_, rho, lam))(xs_a, us_a)
        best = jnp.argmin(merits)
        merit_base = al_merit(xs, us, rho, lam)
        if it == 0:
            # the initializer trajectory carries defects the single-shooting
            # merit can't see; always step onto a real rollout first
            improved = jnp.asarray(True)
        else:
            improved = merits[best] < merit_base
        improved = improved & ~done
        xs = jnp.where(improved, xs_a[best], xs)
        us = jnp.where(improved, us_a[best], us)
        if lm:
            shift = jnp.where(
                improved,
                jnp.maximum(shift * ddp.lm_shrink, ddp.hessian_shift),
                jnp.minimum(shift * ddp.lm_grow, ddp.lm_shift_max),
            )
        if ddp.min_rel_cost > 0.0 and it > 0:
            rel = (merit_base - merits[best]) / jnp.maximum(jnp.abs(merit_base), 1.0)
            done = done | (improved & (rel < ddp.min_rel_cost))

        # first-order multiplier update on the accepted iterate; escalate rho
        # only when the violation did not drop enough (Bertsekas AL schedule)
        _, _, e_now = eval_fn(xs[:-1], us, xs[1:], refs)
        viol = jnp.sum(e_now**2)
        if ddp.multiplier_updates and it > 0:
            # only on accepted steps: updating at a rejected (unchanged)
            # iterate would re-add rho*e at the same point (overshoot)
            lam = lam + jnp.where(improved, rho, 0.0) * masks * e_now
        rho = jnp.where(
            viol > ddp.violation_decrease_factor * viol_prev,
            jnp.minimum(rho * ddp.penalty_increase_rate, ddp.max_penalty),
            rho,
        )
        viol_prev = viol
        if return_history:
            c_now, _, _ = eval_fn(xs[:-1], us, xs[1:], refs)
            hist.append(jnp.stack([
                improved.astype(jnp.float32), merits[best].astype(jnp.float32),
                viol.astype(jnp.float32), jnp.sum(c_now).astype(jnp.float32),
                alphas[best].astype(jnp.float32), xs[-1, 8].astype(jnp.float32),
            ]))

    cost, defects, eqs = eval_fn(xs[:-1], us, xs[1:], refs)
    sol = SqpSolution(
        t_nodes=t_nodes,
        x_traj=xs,
        u_traj=us,
        K=K_out,
        cost=jnp.sum(cost),
        defect_norm=jnp.sum(jnp.abs(defects)),
        eq_norm=jnp.sum(jnp.abs(eqs)),
        step_size=jnp.asarray(1.0),
    )
    extras = []
    if return_al_state:
        extras.append((lam, rho))
    if return_history:
        extras.append(jnp.stack(hist))  # (iters, 6): improved, merit, viol, cost, alpha, zN
    if extras:
        return (sol, *extras)
    return sol
