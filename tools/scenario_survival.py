"""Domain-randomized batched-walking survival sweep -> a JSON table.

BASELINE config 5's scenario axis is "domain-randomized scenarios"; round 3
only exercised randomized batches in STANCE.  This tool runs the full
on-device walking cascade (sim/batch_loop.py) over randomized initial
states at several jitter magnitudes and records the survival fraction
(upright AND progressed) per magnitude.  Runs on whatever jax backend is
available (the GPU by default; CPU smoke:
  JAX_PLATFORMS=cpu SURV_BATCH=8 SURV_SCALES=1.0 python tools/scenario_survival.py).

Survival definition (per scenario, cmd_vel 0.3 m/s for `duration` s of
walking): final base z > 0.8, max tilt < 0.8 rad, and forward progress
> 0.3 * cmd * duration.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# float32 dots at default precision may run reduced (TF32 on a GPU); this
# knob sets the precision for the f32-robustness sweeps.
if os.environ.get("SURV_MATMUL_PRECISION"):
    jax.config.update("jax_default_matmul_precision", os.environ["SURV_MATMUL_PRECISION"])

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    batch = int(os.environ.get("SURV_BATCH", "64"))
    duration = float(os.environ.get("SURV_DURATION", "3.0"))
    scales = [float(s) for s in os.environ.get("SURV_SCALES", "0.5,1.0,1.5,2.0").split(",")]
    cmd = (float(os.environ.get("SURV_CMD", "0.3")), 0.0, 0.0, 0.0)
    gait_name = os.environ.get("SURV_GAIT", "trot")

    # optional KKT regularization override for f32-robustness sweeps
    if os.environ.get("SURV_REGS"):
        d_eps, h_reg = (float(v) for v in os.environ["SURV_REGS"].split(","))
        from bipedal_nmpc.solver import riccati as _ric

        _ric._regs = lambda dtype: (d_eps, h_reg)
        print(f"reg override: dual_eps={d_eps} huu_reg={h_reg}")

    h1 = make_interface_for(os.environ.get("SURV_ROBOT", "h1"))
    riccati = os.environ.get("SURV_RICCATI", "sequential")
    rp = float(os.environ.get("SURV_RICCATI_PENALTY", "1e4"))
    iface = dataclasses.replace(
        h1,
        settings=dataclasses.replace(
            h1.settings, dt=0.02,
            sqp_iterations=int(os.environ.get("SURV_SQP_ITERS", "1")),
            riccati=riccati, riccati_penalty=rp,
        ),
    )
    capture_on = os.environ.get("SURV_CAPTURE", "on") != "off"
    if not capture_on:
        # A/B the captureStepping recovery reflex (configs/<robot>/overrides.info)
        iface = dataclasses.replace(
            iface, task=dataclasses.replace(iface.task, capture=None)
        )
    elif iface.task.capture is not None:
        # capture-gain lever sweeps: SURV_CAP_KV/KP/MAXOFF/POSDB/VELDB
        cap_over = {
            field: float(os.environ[env])
            for field, env in (
                ("kv", "SURV_CAP_KV"), ("kp", "SURV_CAP_KP"),
                ("max_offset", "SURV_CAP_MAXOFF"),
                ("pos_deadband", "SURV_CAP_POSDB"),
                ("vel_deadband", "SURV_CAP_VELDB"),
            )
            if os.environ.get(env)
        }
        if cap_over:
            print("capture overrides:", cap_over)
            iface = dataclasses.replace(
                iface,
                task=dataclasses.replace(
                    iface.task, capture=dataclasses.replace(iface.task.capture, **cap_over)
                ),
            )
    run = jax.jit(
        make_batched_closed_loop(
            iface, BatchLoopConfig(duration=duration), gait=gait_name, gait_at=0.2,
            cmd_vel=cmd, cmd_vel_ki=float(os.environ.get("SURV_CMD_KI", "0.0")),
            cmd_vel_kyaw=float(os.environ.get("SURV_KYAW", "0.0")),
        )
    )

    from bipedal_nmpc.utils.precision import matmul_precision

    # survival thresholds scale with the robot: upright = z above ~82% of
    # the commanded CoM height (H1: 0.98 -> 0.80, matching the historical
    # hardcoded floor), tilt < 0.8, progress > 30% of commanded distance
    z_floor = 0.82 * float(iface.task.com_height)
    out = {
        "metric": "randomized_walking_survival",
        "robot": iface.task and os.environ.get("SURV_ROBOT", "h1"),
        "gait": gait_name,
        "z_floor": round(z_floor, 3),
        "batch": batch,
        "duration_s": duration,
        "cmd_vel": cmd[0],
        "platform": jax.devices()[0].platform,
        "riccati": riccati,
        "matmul_precision": matmul_precision(),
        "capture_stepping": capture_on and iface.task.capture is not None,
        "sqp_iterations": iface.settings.sqp_iterations,
        "per_scale": [],
    }
    progress_min = 0.3 * cmd[0] * duration
    seed = int(os.environ.get("SURV_SEED", "7"))
    for scale in scales:
        X = randomized_initial_states(iface, batch, seed=seed, scale=scale)
        t0 = time.time()
        res = run(X)
        q = np.asarray(res.final_state.q)
        jax.block_until_ready(q)
        wall = time.time() - t0
        finite = np.isfinite(q[:, 0]) & np.isfinite(q[:, 2])
        # fallen scenarios can blow up numerically; treat non-finite as dead
        # and keep the means over finite runs only
        upright = finite & (np.nan_to_num(q[:, 2]) > z_floor) & (
            np.nan_to_num(np.asarray(res.tilt_max), nan=np.inf) < 0.8
        )
        progressed = finite & (np.nan_to_num(q[:, 0]) > progress_min)
        surv = upright & progressed
        out["per_scale"].append(
            {
                "jitter_scale": scale,
                "survival_frac": round(float(np.mean(surv)), 4),
                "upright_frac": round(float(np.mean(upright)), 4),
                "progressed_frac": round(float(np.mean(progressed)), 4),
                "finite_frac": round(float(np.mean(finite)), 4),
                "fell_frac": round(float(np.mean(np.asarray(res.fell))), 4),
                "x_mean_m": round(float(np.mean(q[finite, 0])), 3) if finite.any() else None,
                "z_final_mean_m": round(float(np.mean(q[finite, 2])), 3) if finite.any() else None,
                "wall_s": round(wall, 1),
            }
        )
        print(json.dumps(out["per_scale"][-1]), flush=True)

    path = os.environ.get("SURV_OUT", "chiprun_out/scenario_survival.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
