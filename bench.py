#!/usr/bin/env python
"""Benchmark: batched G1-trot MPC solves/s per device plus replan latency.

Prints ONE JSON line:
  {"metric": "mpc_solves_per_s_per_chip", "value": N, "unit": "solves/s",
   "platform": ..., "device_kind": ..., "chips": ..., ...extras}

Extras report single-solve latency against the reference's 20 ms replan
budget (task.info mpcDesiredFrequency 50) and the 10 ms target.

Runs on the GPU.  Without one it fails, unless the caller chose the CPU
(JAX_PLATFORMS=cpu) for a smoke run:
  BENCH_BATCH=4 BENCH_STEPS=1 BENCH_LAT_SOLVES=2 JAX_PLATFORMS=cpu python bench.py
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", "256"))
STEPS = int(os.environ.get("BENCH_STEPS", "10"))
WARMUP = int(os.environ.get("BENCH_WARMUP", "3"))
LAT_SOLVES = int(os.environ.get("BENCH_LAT_SOLVES", "30"))


def _toolchain_versions():
    """jax / jaxlib versions and the device, recorded with every result so a
    change of numbers can be traced to a change of stack."""
    import jax
    import jaxlib

    from bipedal_nmpc.utils.precision import matmul_precision

    dev = jax.devices()[0]
    return {
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "matmul_precision": matmul_precision(),
    }


def main():
    import jax

    from bipedal_nmpc.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    platform = jax.devices()[0].platform
    print(f"bench: platform {platform}, {len(jax.devices())} device(s)", file=sys.stderr)
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"bench: no GPU found (platform {platform!r}); set JAX_PLATFORMS=cpu "
            "for a CPU smoke run"
        )
    # Production matmul-precision policy (utils/precision.py): full-f32 dots,
    # never TF32 — the bench measures what the closed loop deploys.
    from bipedal_nmpc.utils.precision import matmul_precision

    jax.config.update("jax_default_matmul_precision", matmul_precision())
    import jax.numpy as jnp

    from bipedal_nmpc.backend import select_backends
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.parallel import make_batched_solver
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve

    n_chips = len(jax.devices())

    iface = make_interface_for("g1")
    # Single-candidate RTI line search by default (tools/alpha_sweep.py is
    # the safety sweep against the five-candidate filter).  BENCH_ALPHAS=none
    # selects the pure full-step RTI (no merit pass at all — solver/sqp.py
    # empty-alphas mode); the filter's step cap is what absorbs big reference
    # discontinuities (see OcpSettings.linesearch_alphas).
    _alpha_env = os.environ.get("BENCH_ALPHAS", "1.0")
    alphas = (
        ()
        if _alpha_env.strip().lower() in ("none", "")
        else tuple(float(a) for a in _alpha_env.split(","))
    )
    settings = select_backends(
        dataclasses.replace(iface.settings, sqp_iterations=1, linesearch_alphas=alphas)
    )
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0, settings.num_intervals + 1)

    def throughput(iface_x, refs_x, xs_x, us_x, steps, warmup, donate):
        sv = make_batched_solver(
            iface_x.model, iface_x.info, settings, iface_x.Q, iface_x.R,
            donate_warm_start=donate,
        )
        tl = lambda a: jnp.broadcast_to(a[None], (BATCH,) + a.shape).copy()
        rb, tb, xb = jax.tree.map(tl, refs_x), tl(t_nodes), tl(x0)
        xsb, usb = tl(xs_x), tl(us_x)
        for _ in range(warmup):
            s = sv(rb, tb, xb, xsb, usb)
            xsb, usb = s.x_traj, s.u_traj  # warm-start chaining
        jax.block_until_ready(s.x_traj)
        te = time.perf_counter()
        for _ in range(steps):
            s = sv(rb, tb, xb, xsb, usb)
            xsb, usb = s.x_traj, s.u_traj
        jax.block_until_ready(s.x_traj)
        return BATCH * steps / (time.perf_counter() - te) / n_chips, s

    # ---- batched throughput (one real-time-iteration solve per scenario);
    # donating the warm-start buffers saves an output copy per step
    # (BENCH_DONATE=0 turns it off)
    solves_per_s, sol = throughput(
        iface, refs, xs, us, STEPS, WARMUP, os.environ.get("BENCH_DONATE", "1") != "0"
    )
    head = {
        "metric": "mpc_solves_per_s_per_chip",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "batch": BATCH,
        "chips": n_chips,
        "riccati": settings.riccati,
        "defect_l1": float(jnp.sum(sol.defect_norm[0])),
    }
    if os.environ.get("BENCH_THROUGHPUT_ONLY"):
        # big-batch sweeps skip the single-solve latency sections (their
        # compiles dominate wall time and don't depend on batch size)
        print(json.dumps({**head, **_toolchain_versions()}))
        return

    # ---- single-solve latency, host-observed (includes the dispatch)
    single = jax.jit(
        lambda refs, t, x, xs, us: sqp_solve(
            iface.model, iface.info, settings, iface.Q, iface.R, refs, t, x, xs, us
        )
    )
    sol1 = single(refs, t_nodes, x0, xs, us)
    jax.block_until_ready(sol1.x_traj)
    lats = []
    xs1, us1 = sol1.x_traj, sol1.u_traj
    for _ in range(LAT_SOLVES):
        t1 = time.perf_counter()
        sol1 = single(refs, t_nodes, x0, xs1, us1)
        jax.block_until_ready(sol1.x_traj)
        lats.append(time.perf_counter() - t1)
        xs1, us1 = sol1.x_traj, sol1.u_traj
    p99 = float(np.percentile(np.asarray(lats) * 1e3, 99))
    p50 = float(np.percentile(np.asarray(lats) * 1e3, 50))

    # ---- dispatch floor: a trivial jitted op's round trip
    triv = jax.jit(lambda x: x + 1.0)
    jax.block_until_ready(triv(x0))
    rtts = []
    for _ in range(LAT_SOLVES):
        t1 = time.perf_counter()
        jax.block_until_ready(triv(x0))
        rtts.append(time.perf_counter() - t1)
    dispatch_floor = float(np.median(np.asarray(rtts) * 1e3))

    # ---- device-side RTI latency: K warm-started solves chained in ONE
    # dispatch (lax.scan), the way a deployed real-time-iteration loop keeps
    # state on the device.  (wall - dispatch floor) / K isolates per-solve
    # device latency from the host round trip.
    K = 10

    @jax.jit
    def chained(refs, t, x, xs, us):
        def body(carry, _):
            cxs, cus = carry
            s = sqp_solve(
                iface.model, iface.info, settings, iface.Q, iface.R, refs, t, x, cxs, cus
            )
            return (s.x_traj, s.u_traj), s.defect_norm
        carry, defects = jax.lax.scan(body, (xs, us), None, length=K)
        return carry[0], defects

    out = chained(refs, t_nodes, x0, xs, us)
    jax.block_until_ready(out)
    cts = []
    for _ in range(max(10, LAT_SOLVES)):
        t1 = time.perf_counter()
        out = chained(refs, t_nodes, x0, xs, us)
        jax.block_until_ready(out)
        cts.append(time.perf_counter() - t1)
    cts_ms = np.asarray(cts) * 1e3
    chained_p50 = float((np.percentile(cts_ms, 50) - dispatch_floor) / K)
    chained_p99 = float((np.percentile(cts_ms, 99) - dispatch_floor) / K)

    # ---- breadth point: the single-rigid-body model (centroidalModelType 1)
    # on the same G1 task.  A failure here fails the bench.
    extras = {}
    if os.environ.get("BENCH_EXTRA", "1") != "0":
        info_srbd = dataclasses.replace(
            iface.info, model_type=1,
            q_j_nominal=tuple(float(v) for v in np.asarray(iface.initial_state)[12:]),
        )
        iface_srbd = dataclasses.replace(iface, info=info_srbd)
        refs_s = build_refs(info_srbd, frozen.gait, frozen.swing, frozen.target, t_nodes)
        xs_s, us_s = initial_trajectory(info_srbd, refs_s, x0, settings.num_intervals + 1)
        srbd, _ = throughput(iface_srbd, refs_s, xs_s, us_s, max(2, STEPS // 2), 2, False)
        extras["srbd_solves_per_s"] = round(srbd, 2)

    print(
        json.dumps(
            {
                **head,
                "p50_solve_ms": round(p50, 3),
                "p99_solve_ms": round(p99, 3),
                "dispatch_floor_ms": round(dispatch_floor, 3),
                "device_solve_p50_ms": round(chained_p50, 3),
                "device_solve_p99_ms": round(chained_p99, 3),
                "p99_vs_10ms_budget": round(10.0 / chained_p99, 4),
                **_toolchain_versions(),
                **extras,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
