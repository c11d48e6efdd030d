#!/usr/bin/env python
"""Riccati backend A/B on the GPU: the Triton kernel against the XLA scan.

Times the whole solve, end to end, for each backend in one process, in the
order XLA, kernel, kernel, XLA:

- B=1: warm replans through `MpcRunner.advance` (G1, 67 nodes, the task's
  line search), wall time per replan ended by block_until_ready;
- B=256: warm-chained batched steps through `parallel.make_batched_solver`;
- the sweep alone (`solve_lqr` / `solve_lqr_triton`) at both batches, on
  the linearized nodes of the G1 cold replan.

    python tools/riccati_ab.py [--reps 30]

Prints one line per measurement and the card's name and power limit.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _median_ms(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts)), 1e3 * float(np.percentile(ts, 90))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.ocp.linearize import linearize_node_structured
    from bipedal_nmpc.parallel import make_batched_solver
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.solver import build_refs, initial_trajectory
    from bipedal_nmpc.solver.riccati import solve_lqr, solve_lqr_triton
    from bipedal_nmpc.solver.sqp import eq_mask_from_flags
    from bipedal_nmpc.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("riccati_ab: needs a GPU")
    enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    base = make_interface_for("g1")
    rm = base.make_reference_manager()
    rm.set_gait(base.task.gait_library["trot"], start_time=0.05)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(base.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(base.initial_state)
    xs, us = initial_trajectory(base.info, refs, x0, base.settings.num_intervals + 1)

    def iface_for(backend):
        return dataclasses.replace(
            base, settings=dataclasses.replace(base.settings, riccati=backend))

    # ---- B=1 warm replan through the entry point
    runners = {}
    for backend in ("sequential", "triton"):
        mpc = MpcRunner(iface_for(backend))
        mpc.rm.set_gait(base.task.gait_library["trot"], start_time=0.05)
        mpc.advance(0.0, x0)  # cold replan (compiles), then warm
        runners[backend] = mpc
    for backend in ("sequential", "triton", "triton", "sequential"):
        mpc = runners[backend]
        med, p90 = _median_ms(lambda: mpc.advance(0.0, x0).u_traj, args.reps)
        print(f"B=1 warm replan riccati={backend}: median {med:.3f} ms, p90 {p90:.3f} ms", flush=True)

    # ---- B=256 batched, warm-chained
    B = 256
    tile = lambda a: jnp.broadcast_to(a[None], (B,) + a.shape)
    batch = (jax.tree.map(tile, refs), tile(t_nodes), tile(x0), tile(xs), tile(us))
    solvers = {}
    for backend in ("sequential", "triton"):
        s = iface_for(backend)
        solvers[backend] = make_batched_solver(
            s.model, s.info, s.settings, s.Q, s.R, donate_warm_start=False)
        sol = solvers[backend](*batch)
        solvers[backend] = (solvers[backend], sol)
    for backend in ("sequential", "triton", "triton", "sequential"):
        fn, sol = solvers[backend]
        step = lambda: fn(batch[0], batch[1], batch[2], sol.x_traj, sol.u_traj).u_traj
        med, p90 = _median_ms(step, max(5, args.reps // 3))
        print(f"B={B} batched step riccati={backend}: median {med:.3f} ms, p90 {p90:.3f} ms "
              f"({B / med * 1e3:.0f} solves/s)", flush=True)

    # ---- the sweep alone on the cold replan's nodes
    with jax.default_matmul_precision("float32"):
        nodes = jax.jit(jax.vmap(
            lambda x, u, xn, r: linearize_node_structured(
                base.model, base.info, base.settings, base.Q, base.R, x, u, xn, r)
        ))(xs[:-1], us, xs[1:], refs)
        masks = eq_mask_from_flags(refs.contact_flags)
        for b in (1, B):
            nb = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (b,) + a.shape), nodes)
            mb = jnp.broadcast_to(masks[None], (b,) + masks.shape)
            dx0 = jnp.zeros((b, nodes.A.shape[-1]), nodes.A.dtype)
            fns = {"sequential": jax.jit(jax.vmap(solve_lqr)),
                   "triton": jax.jit(jax.vmap(solve_lqr_triton))}
            for backend in ("sequential", "triton", "triton", "sequential"):
                med, p90 = _median_ms(lambda: fns[backend](nb, mb, dx0).du, args.reps)
                print(f"B={b} sweep alone riccati={backend}: median {med:.3f} ms, "
                      f"p90 {p90:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
