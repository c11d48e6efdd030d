#!/usr/bin/env python
"""RTI linesearch-candidate safety sweep (VERDICT r2 item #5).

Measures whether a single-candidate linesearch (alphas=(1.0,)) is as safe as
the two-candidate default across the situations where a fixed step could
misbehave: cold start, gait switch mid-run, state disturbance, and stale
observations.  Writes chiprun_out/alpha_sweep.json.

Run: JAX_PLATFORMS=cpu python tools/alpha_sweep.py
"""
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_sweep(alphas):
    import jax
    import jax.numpy as jnp

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner

    iface = make_interface_for("h1")
    settings = dataclasses.replace(
        iface.settings, sqp_iterations=1, linesearch_alphas=tuple(alphas)
    )
    iface = dataclasses.replace(iface, settings=settings)
    out = {}

    # ---- cold start: repeated RTI solves from the Initializer trajectory
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    x0 = jnp.asarray(iface.initial_state)
    defects = []
    for _ in range(8):
        sol = mpc.advance(0.0, x0)
        defects.append(float(sol.defect_norm))
    out["cold"] = {"defects": defects, "final": defects[-1]}

    # ---- rolling replans with a gait switch at t=0.5 and switch-back at 1.0
    mpc = MpcRunner(iface)
    x = np.asarray(iface.initial_state)
    defects, steps = [], []
    for k in range(75):  # 1.5 s at 50 Hz
        t = 0.02 * k
        if k == 25:
            mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=t + 0.1)
        if k == 50:
            mpc.rm.set_gait(iface.task.gait_library["stance"], start_time=t + 0.1)
        sol = mpc.advance(t, jnp.asarray(x))
        defects.append(float(sol.defect_norm))
        steps.append(float(sol.step_size))
        # follow the plan (no plant): next observation = plan at t+dt
        from bipedal_nmpc.runtime.mrt import evaluate_policy

        x = np.asarray(evaluate_policy(sol, t + 0.02, jnp.asarray(x)).x_star)
    out["gait_switch"] = {
        "max_defect_after_warmup": float(np.max(defects[5:])),
        "final": defects[-1],
        "min_step": float(np.min(steps)),
    }

    # ---- disturbance: 0.3 m/s lateral velocity + 5 cm base kicks mid-run
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    x = np.asarray(iface.initial_state)
    defects = []
    for k in range(40):
        t = 0.02 * k
        if k in (15, 25):
            x = x.copy()
            x[1] += 0.3  # lateral momentum kick
            x[8] -= 0.05  # base drop
        sol = mpc.advance(t, jnp.asarray(x))
        defects.append(float(sol.defect_norm))
        from bipedal_nmpc.runtime.mrt import evaluate_policy

        x = np.asarray(evaluate_policy(sol, t + 0.02, jnp.asarray(x)).x_star)
    out["disturbance"] = {
        "max_defect_after_warmup": float(np.max(defects[5:])),
        "final": defects[-1],
    }

    # ---- stale observation: feed the state from two replans ago
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    x_hist = [np.asarray(iface.initial_state)] * 3
    defects = []
    for k in range(40):
        t = 0.02 * k
        sol = mpc.advance(t, jnp.asarray(x_hist[0]))  # 40 ms stale
        defects.append(float(sol.defect_norm))
        from bipedal_nmpc.runtime.mrt import evaluate_policy

        x_new = np.asarray(evaluate_policy(sol, t + 0.02, jnp.asarray(x_hist[-1])).x_star)
        x_hist = x_hist[1:] + [x_new]
    out["stale_obs"] = {
        "max_defect_after_warmup": float(np.max(defects[5:])),
        "final": defects[-1],
    }
    return out


def main():
    results = {}
    for name, alphas in [("two", (1.0, 0.5)), ("one", (1.0,))]:
        results[name] = run_sweep(alphas)
        print(name, json.dumps(results[name]), flush=True)
    # equivalence verdict: the single-candidate run must match the
    # two-candidate run within 2x on every scenario's worst defect and
    # stay absolutely small
    ok = True
    for scen in results["two"]:
        a = results["one"][scen].get("max_defect_after_warmup", results["one"][scen]["final"])
        b = results["two"][scen].get("max_defect_after_warmup", results["two"][scen]["final"])
        if not (a < max(2.0 * b, 5e-3)):
            ok = False
    results["equivalent"] = ok
    out_path = os.path.join(os.path.dirname(__file__), "..", "chiprun_out", "alpha_sweep.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print("equivalent:", ok, "->", out_path)


if __name__ == "__main__":
    main()
