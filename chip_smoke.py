#!/usr/bin/env python
"""Smoke run of the system's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: phases 1-5
    python chip_smoke.py --four    # four cards: the sharded batched solve
                                   # and the sharded cascade, each against
                                   # its unsharded run (phase 6 only)

Phases, in order; the first failure stops the run with a non-zero exit:

1. device: the first JAX device must be a GPU (there is no CPU fallback);
2. single-robot replan: G1 at the full 67-node horizon through
   `make_interface_for` and `MpcRunner.advance` (one cold, ten warm replans);
3. correctness: the card's float32 replan against the same replan in float64
   on the CPU device, and the Riccati sweep alone (XLA scan and the Triton
   kernel) against the float64 dense-KKT oracle of tests/test_riccati.py;
4. batched solve at B=256 through `parallel.make_batched_solver`;
5. closed-loop cascade at B=64 for 0.2 s through
   `sim.batch_loop.make_batched_closed_loop`, then the tests marked `gpu`.

The last line printed is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# Tolerances of the float32 card against a float64 reference, relative to the
# largest magnitude of the compared quantity.  The stage-KKT solves amplify
# float32 round-off (unit 6e-8) by the KKT's conditioning, which the dual
# regularization (100 eps: 1.2e-5 in float32, 1e-9 in float64) bounds near
# 1e4, so inputs agree to ~1e-3.  The feedback gains K carry that error once
# more through the cost-to-go recursion over 67 stages: 1e-2.
RTOL_U = 1e-3
RTOL_K = 1e-2
# The sweep's QP objective in float32 against the exact float64 optimum:
# float32's dual regularization (1.2e-5) leaves relative constraint
# residuals near 6e-5 and moves the objective by ~4e-3 on this replan (CPU
# measurement, XLA scan and kernel alike).  A kernel within float32
# round-off of the optimum (OBJ_FLOOR) passes however small the scan's own
# error is.
RTOL_OBJ = 1e-2
OBJ_FLOOR = 1e-6
# B=256 lane 0 vs the single replan, and sharded vs unsharded (--four): the
# same per-lane float32 program up to XLA's choice of kernels and summation
# order for another batch size, amplified by the same stage KKT; same bounds.

HORIZON_NODES = 67
BATCH = 256
CASCADE_BATCH = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")
    log(f"  ok: {msg}")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def phase_device(n_cards: int):
    import jax
    import jaxlib

    log("== phase 1: device")
    devs = jax.devices()
    kind = devs[0].device_kind
    log(f"  platform {devs[0].platform}, device_kind {kind!r}, count {len(devs)}")
    check(devs[0].platform == "gpu", "the first JAX device is a GPU")
    check(len(devs) >= n_cards, f"{n_cards} card(s) visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(smi)
    log(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def g1_problem(iface):
    """Frozen trot references and the cold-start trajectory for one replan."""
    import jax.numpy as jnp

    from bipedal_nmpc.solver import build_refs, initial_trajectory

    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.05)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0, iface.settings.num_intervals + 1)
    return refs, t_nodes, x0, xs, us


def phase_replan(iface):
    import jax.numpy as jnp

    from bipedal_nmpc.runtime.mpc_runner import MpcRunner

    log("== phase 2: single-robot replan (G1, MpcRunner.advance)")
    info = iface.info
    N = iface.settings.num_intervals
    log(f"  G1 stand-in: nodes {N}, state {info.state_dim}, input {info.input_dim}, "
        f"contacts {len(info.contact_frame_ids)}, mass {info.robot_mass:.3f} kg")
    check((N, info.state_dim, info.input_dim) == (HORIZON_NODES, 24, 24),
          "full width: 67 nodes, state 24, input 24")
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.05)
    x0 = jnp.asarray(iface.initial_state)
    sols = []
    for i in range(11):
        t0 = time.perf_counter()
        sol = mpc.advance(0.0, x0)  # advance ends in block_until_ready
        dt = time.perf_counter() - t0
        sols.append(sol)
        kind = "cold" if i == 0 else f"warm {i}"
        label = "compile+run" if i < 2 else "run"
        log(f"  replan {kind}: {label} {dt:.3f} s, defect {float(sol.defect_norm):.3e}, "
            f"eq {float(sol.eq_norm):.3e}, step {float(sol.step_size)}")
        check(all(bool(np.all(np.isfinite(np.asarray(a))))
                  for a in (sol.x_traj, sol.u_traj, sol.K)), f"replan {i} finite")
        if i >= 5:
            check(float(sol.defect_norm) < 1e-3 and float(sol.eq_norm) < 1e-2,
                  f"replan {i}: defect < 1e-3 and eq < 1e-2")
    return sols


def qp_objective_and_violation(nodes, masks, dx, du):
    """Objective of the sweep's QP at (dx, du), and its largest dynamics and
    active equality residuals relative to the largest |c| and |e|."""
    n = {f: np.asarray(getattr(nodes, f), np.float64) for f in nodes._fields}
    dx, du, m = np.asarray(dx, np.float64), np.asarray(du, np.float64), np.asarray(masks)
    x, xn = dx[:-1], dx[1:]
    obj = (0.5 * np.einsum("ki,kij,kj->", x, n["Qxx"], x)
           + 0.5 * np.einsum("ki,kij,kj->", du, n["Quu"], du)
           + np.einsum("ki,kij,kj->", du, n["Qux"], x)
           + np.sum(n["qx"] * x) + np.sum(n["qu"] * du))
    dyn = np.einsum("kij,kj->ki", n["A"], x) + np.einsum("kij,kj->ki", n["B"], du) + n["c"] - xn
    eq = m * (np.einsum("kij,kj->ki", n["C"], x) + np.einsum("kij,kj->ki", n["D"], du) + n["e"])
    return obj, max(np.max(np.abs(dyn)) / np.max(np.abs(n["c"])),
                    np.max(np.abs(eq)) / max(np.max(np.abs(n["e"])), 1e-30))


def phase_correctness(iface, sols):
    import dataclasses

    import jax
    import jax.numpy as jnp

    import bipedal_nmpc.solver.riccati as riccati
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.ocp.linearize import linearize_node_structured
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.solver.riccati import solve_lqr, solve_lqr_triton
    from bipedal_nmpc.solver.sqp import eq_mask_from_flags
    from test_riccati import _dense_solution

    log("== phase 3: float32 card vs float64 CPU reference")
    # The cold replan: both precisions take the same full step from the
    # same initial trajectory (at the warm fixed point one precision can
    # reject every step while the other accepts one).
    card = sols[0]
    cpu = jax.devices("cpu")[0]
    # The stage KKT's active rows are rank-deficient in stance (toe and heel
    # of one rigid foot: 12 rows of rank 10), so its dual regularization of
    # 100 eps of the dtype picks the solution among near-equal ones; float32
    # and float64 constants alone move u by 6% and K by 20% (CPU measurement
    # on this replan).  The reference therefore keeps float32's constants
    # and computes everything else in float64: what differs is round-off.
    f32_regs = riccati._regs(jnp.float32)
    regs = riccati._regs
    try:
        riccati._regs = lambda dtype: f32_regs
        with jax.enable_x64(True), jax.default_device(cpu):
            iface64 = make_interface_for("g1")
            # the reference runs the plain XLA scan on the CPU device
            iface64 = dataclasses.replace(
                iface64, settings=dataclasses.replace(iface64.settings, riccati="sequential"))
            mpc64 = MpcRunner(iface64)
            mpc64.rm.set_gait(iface64.task.gait_library["trot"], start_time=0.05)
            t0 = time.perf_counter()
            ref = mpc64.advance(0.0, jnp.asarray(iface64.initial_state))
            log(f"  float64 CPU replan: {time.perf_counter() - t0:.1f} s (compile included), "
                f"step {float(ref.step_size)} (card: {float(card.step_size)})")
            # the linearized nodes of that replan, in float64
            refs, t_nodes, x0, xs, us = g1_problem(iface64)
            info, model, st = iface64.info, iface64.model, iface64.settings
            nodes64 = jax.jit(jax.vmap(
                lambda x, u, xn, r: linearize_node_structured(
                    model, info, st, iface64.Q, iface64.R, x, u, xn, r)
            ))(xs[:-1], us, xs[1:], refs)
            masks64 = eq_mask_from_flags(refs.contact_flags)
            nodes64, masks64 = jax.device_get((nodes64, masks64))
    finally:
        riccati._regs = regs
    e_x = rel_err(card.x_traj, ref.x_traj)
    e_u = rel_err(card.u_traj, ref.u_traj)
    e_k = rel_err(card.K, ref.K)
    log(f"  replan: rel err x_traj {e_x:.3e}, u_traj {e_u:.3e} (tol {RTOL_U}), "
        f"K {e_k:.3e} (tol {RTOL_K})")
    check(e_x < RTOL_U and e_u < RTOL_U, "card replan x_traj and u_traj match float64")
    check(e_k < RTOL_K, "card replan K matches float64")

    # The sweep alone against the dense-KKT oracle.  The same rank
    # deficiency leaves directions (internal toe/heel forces) along which
    # the QP objective is nearly flat, so du itself is not unique to
    # float32 precision; the oracle comparison is on the objective value and
    # on feasibility, which are.
    t0 = time.perf_counter()
    dxs_o, dus_o = _dense_solution(nodes64, masks64, np.zeros(nodes64.A.shape[-1]))
    obj_o, viol_o = qp_objective_and_violation(nodes64, masks64, dxs_o, dus_o)
    log(f"  dense-KKT oracle (float64, numpy): {time.perf_counter() - t0:.1f} s, "
        f"objective {obj_o:.9e}, rel violation {viol_o:.1e}")
    nodes32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), nodes64)
    masks32 = jnp.asarray(masks64, jnp.float32)
    dx0 = jnp.zeros(nodes32.A.shape[-1], jnp.float32)
    errs = {}
    with jax.default_matmul_precision("float32"):
        outs = {name: jax.jit(fn)(nodes32, masks32, dx0)
                for name, fn in (("xla scan", solve_lqr), ("triton kernel", solve_lqr_triton))}
    for name, out in outs.items():
        obj, viol = qp_objective_and_violation(nodes64, masks64, out.dx, out.du)
        errs[name] = abs(obj - obj_o) / abs(obj_o)
        log(f"  riccati {name}: objective rel err {errs[name]:.3e}, rel violation {viol:.1e}")
        check(viol < RTOL_U, f"{name} solution feasible")
    check(errs["xla scan"] < RTOL_OBJ, "XLA scan objective matches the float64 oracle")
    check(errs["triton kernel"] <= max(2.0 * errs["xla scan"], OBJ_FLOOR),
          "Triton kernel error <= 2x the XLA scan's")
    e_kk = rel_err(outs["triton kernel"].K, outs["xla scan"].K)
    log(f"  kernel vs XLA scan on the card: rel err K {e_kk:.3e}")
    check(e_kk < RTOL_K, "kernel K matches the XLA scan's")


def phase_batched(iface, cold):
    import jax
    import jax.numpy as jnp

    from bipedal_nmpc.parallel import make_batched_solver

    log(f"== phase 4: batched solve, B={BATCH}")
    refs, t_nodes, x0, xs, us = g1_problem(iface)
    solver = make_batched_solver(iface.model, iface.info, iface.settings, iface.Q, iface.R,
                                 donate_warm_start=False)
    tile = lambda a: jnp.broadcast_to(a[None], (BATCH,) + a.shape)
    args = (jax.tree.map(tile, refs), tile(t_nodes), tile(x0), tile(xs), tile(us))
    t0 = time.perf_counter()
    compiled = solver.lower(*args).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    sol = jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    log(f"  seconds per batched step: median {np.median(ts):.4f}, min {np.min(ts):.4f} "
        f"({BATCH / np.median(ts):.0f} solves/s)")
    check(bool(np.all(np.isfinite(np.asarray(sol.u_traj)))), "batched solve finite")
    e_u = rel_err(sol.u_traj[0], cold.u_traj)
    e_k = rel_err(sol.K[0], cold.K)
    log(f"  lane 0 vs single cold replan: rel err u {e_u:.3e}, K {e_k:.3e}")
    check(e_u < RTOL_U and e_k < RTOL_K, "lane 0 matches the single solve")


def phase_cascade(iface):
    import jax

    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    log(f"== phase 5: closed-loop cascade, B={CASCADE_BATCH}, 0.2 s")
    loop = make_batched_closed_loop(iface, BatchLoopConfig(duration=0.2))
    X = randomized_initial_states(iface, CASCADE_BATCH, seed=0)
    t0 = time.perf_counter()
    res = jax.block_until_ready(loop(X))
    log(f"  compile+run {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = jax.block_until_ready(loop(X))
    log(f"  run {time.perf_counter() - t0:.3f} s")
    finite = all(bool(np.all(np.isfinite(np.asarray(a)))) for a in jax.tree.leaves(res.final_state))
    log(f"  fallen {int(np.sum(np.asarray(res.fell)))}/{CASCADE_BATCH}")
    check(finite, "cascade final_state finite")


def phase_card_tests():
    """The tests marked `gpu` (they skip on machines without a card), in
    this process: a second JAX process could not get the card's memory."""
    import pytest

    log("== phase 5b: card-only tests (pytest -m gpu)")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    check(rc == 0, f"card-only tests pass (pytest exit {int(rc)})")


def phase_four(iface):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bipedal_nmpc.parallel import make_batched_solver, make_mesh, shard_batch
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    log("== phase 6: four cards, sharded vs unsharded")
    mesh = make_mesh("data", jax.devices()[:4])
    refs, t_nodes, x0, xs, us = g1_problem(iface)
    tile = lambda a: jnp.broadcast_to(a[None], (BATCH,) + a.shape)
    args = (jax.tree.map(tile, refs), tile(t_nodes), tile(x0), tile(xs), tile(us))
    m, i, s, Q, R = iface.model, iface.info, iface.settings, iface.Q, iface.R
    sharded = make_batched_solver(m, i, s, Q, R, mesh, "data", donate_warm_start=False)
    single = make_batched_solver(m, i, s, Q, R, donate_warm_start=False)
    out4 = jax.block_until_ready(sharded(*shard_batch(args, mesh, "data")))
    t0 = time.perf_counter()
    out4 = jax.block_until_ready(sharded(*shard_batch(args, mesh, "data")))
    log(f"  sharded B={BATCH} step {time.perf_counter() - t0:.4f} s over 4 cards")
    out1 = jax.block_until_ready(single(*args))
    err = max(rel_err(out4.u_traj, out1.u_traj), rel_err(out4.x_traj, out1.x_traj))
    log(f"  solve: rel err sharded vs unsharded {err:.3e} (tol {RTOL_U})")
    check(err < RTOL_U, "sharded batched solve == unsharded")

    cfg = BatchLoopConfig(duration=0.2)
    X = randomized_initial_states(iface, CASCADE_BATCH, seed=0)
    loop4 = make_batched_closed_loop(iface, cfg, mesh=mesh)
    res4 = jax.block_until_ready(loop4(jax.device_put(X, NamedSharding(mesh, P("data")))))
    res1 = jax.block_until_ready(make_batched_closed_loop(iface, cfg)(X))
    cerr = rel_err(res4.final_state.q, res1.final_state.q)
    log(f"  cascade: rel err sharded vs unsharded q {cerr:.3e} (tol {RTOL_U}), "
        f"fallen {int(np.sum(np.asarray(res4.fell)))}/{CASCADE_BATCH}")
    check(bool(np.all(np.isfinite(np.asarray(res4.final_state.q)))), "sharded cascade finite")
    check(cerr < RTOL_U, "sharded cascade == unsharded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded solve and cascade")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    devs = phase_device(n_cards)

    from bipedal_nmpc.backend import select_backends
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.utils.compile_cache import enable_compile_cache

    log(f"  compile cache: {enable_compile_cache()}")
    iface = make_interface_for("g1")
    log(f"  riccati backend on this device: {select_backends(iface.settings).riccati}")
    if args.four:
        phase_four(iface)
    else:
        sols = phase_replan(iface)
        phase_correctness(iface, sols)
        phase_batched(iface, sols[0])
        phase_cascade(iface)
        phase_card_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
