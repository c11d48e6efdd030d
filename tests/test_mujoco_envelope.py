"""Physics robustness envelope (VERDICT round-1 item #6).

The reference's de-facto e2e procedure is walking bringup under actuation
delay (restart_mujoco.py:11-83 + hw_sim.yaml 9 ms delay buffer); these tests
close that loop in CI: cmd_vel walking with the delay buffer on, gait
switch back to stance mid-run, and a terrain-scene smoke.
"""
import os

import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

MJCF = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/unitree_h1/h1_description/mjcf/scene.xml"
)
MJCF_TERRAIN = os.path.join(
    REFERENCE_ASSETS,
    "bipedal_robot_example/unitree_h1/h1_description/mjcf/scene_terrain.xml",
)
pytestmark = pytest.mark.skipif(not os.path.exists(MJCF), reason="H1 MJCF unavailable")


def _make(mjcf, delay=0.0):
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("h1")
    sim = MujocoSimBackend(
        mjcf, list(iface.task.joint_names), MujocoSimConfig(command_delay_s=delay)
    )
    x0 = iface.initial_state
    upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    return iface, sim


def test_walk_cmd_vel_with_delay_and_stance_return():
    """Trot forward at cmd_vel 0.4 m/s for ~4.5 s of real physics with the
    9 ms actuation delay buffer (hw_sim.yaml:2 semantics), then STOP (still
    trotting — a decelerating stationary target arrests the walk), then
    plant to stance and keep balancing — displacement + stability asserted.

    Stop-then-plant is the physical bringdown: splicing double-support
    while still moving at 0.4 m/s freezes the feet wherever the trot left
    them (possibly mid-swing, narrow support) and the stance hold slowly
    tips — the measured failure of the old instant switch-back once the
    fused replan raised the worker to its full 50 Hz cadence."""
    from bipedal_nmpc.reference.target import (
        cmd_vel_to_target_trajectories,
        stationary_target,
    )
    from bipedal_nmpc.runtime.controller import BipedalController, ControllerConfig

    iface, sim = _make(MJCF, delay=0.009)
    ctrl = BipedalController(iface, ControllerConfig(mpc_async=True))
    try:
        ctrl.starting(sim.time, sim.rbd_state())
        control_dt = 1.0 / 500.0
        substeps = max(1, int(round(control_dt / sim.timestep)))
        cmd = np.array([0.4, 0.0, 0.0, 0.0])
        trot_at, walk_from, stance_at, end = 0.5, 1.0, 5.5, 8.0
        trot_set = stance_set = False
        plant_at = None
        last_retarget = -np.inf
        while sim.time < end:
            t = sim.time
            if not trot_set and t > trot_at:
                ctrl.set_gait(iface.task.gait_library["trot"], start_time=t + 0.1)
                trot_set = True
            if not stance_set and t > stance_at:
                # stop the WALK first (decelerating target, still trotting)
                x_obs = np.asarray(ctrl.last_observation[1])
                ctrl.set_target(
                    stationary_target(t, x_obs, iface.command_config, iface.info.input_dim)
                )
                stance_set = True
                plant_at = t + 1.0
            if plant_at is not None and t > plant_at:
                # ...then plant to double support once stopped
                ctrl.set_gait(iface.task.gait_library["stance"], start_time=t + 0.1)
                x_obs = np.asarray(ctrl.last_observation[1])
                ctrl.set_target(
                    stationary_target(t, x_obs, iface.command_config, iface.info.input_dim)
                )
                plant_at = None
            # stream the velocity command like a teleop publisher (the target
            # extrapolates from the *current* observation, so re-issue it)
            if trot_set and not stance_set and t > walk_from and t - last_retarget > 0.2:
                x_obs = np.asarray(ctrl.last_observation[1])
                ctrl.set_target(
                    cmd_vel_to_target_trajectories(
                        cmd, t, x_obs, iface.command_config, iface.info.input_dim
                    )
                )
                last_retarget = t
            # pace sim time to the background solver (main.cc CPU-sim sync).
            # 60 ms: with the fused replan the worker sustains ~45 Hz, so
            # this barely throttles an idle host, but under full-suite CPU
            # contention it keeps consumed policies fresh enough that the
            # walk doesn't depend on scheduler luck (one suite-load flake
            # observed at 150 ms staleness).
            ctrl.async_mpc.wait_until_fresh(t, max_staleness=0.06)
            rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
            c = ctrl.update(t, rbd)
            assert np.all(np.isfinite(c.tau_ff))
            sim.apply_command(c)
            sim.step(substeps)
            if not ctrl.safe:
                break
        pos = sim.ground_truth()[0]
    finally:
        ctrl.stop()
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.85, pos
    # ~5 s of commanded 0.4 m/s walking: demand real forward progress
    assert pos[0] > 0.8, f"walked only {pos[0]:.2f} m"
    assert abs(pos[1]) < 0.5, pos


def test_walk_kalman_estimator_beyond_reference_delay():
    """WALKING with the Kalman estimator in the loop (no ground truth on
    the control path) AND an actuation delay BEYOND the reference's 9 ms
    (VERDICT r3 weak #8: walking loops previously used sim.rbd_state()
    ground truth, and delay was pinned at exactly 9 ms).  Measured delay
    envelope (2026-08-21, cmd 0.3 with CmdVelFollower): 9 ms v_avg 0.300
    est_err 4.2 cm; 12 ms 0.304 / 6.2 cm; 15 ms 0.313 / 8.3 cm; 18 ms
    0.318 / 7.7 cm; 21 ms 0.329 / 6.9 cm — NO break point up to 2.3x the
    reference's delay; only the lateral drift grows (y -0.15 -> -0.30 m
    over 5.5 s).  This test pins the 12 ms point."""
    from bipedal_nmpc.reference.target import CmdVelFollower
    from bipedal_nmpc.runtime.controller import BipedalController, ControllerConfig

    iface, sim = _make(MJCF, delay=0.012)
    ctrl = BipedalController(iface, ControllerConfig(mpc_async=True, estimator="kalman"))
    cmd_vx = 0.3
    follower = CmdVelFollower(
        np.array([cmd_vx, 0.0, 0.0, 0.0]), iface.command_config,
        iface.info.input_dim, ki=1.2,
    )
    try:
        imu = sim.imu()
        qj, dqj = sim.joint_states()
        ctrl.starting_from_sensors(
            sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
            base_pos_guess=sim.ground_truth()[0],
        )
        control_dt = 1.0 / 500.0
        substeps = max(1, int(round(control_dt / sim.timestep)))
        trot_set = False
        t_walk0 = x_walk0 = None
        while sim.time < 5.5:
            t = sim.time
            if not trot_set and t > 0.5:
                ctrl.set_gait(iface.task.gait_library["trot"], start_time=t + 0.1)
                trot_set = True
            if t > 1.0:
                traj = follower.update(*ctrl.last_observation)
                if traj is not None:
                    ctrl.set_target(traj)
                if t_walk0 is None:
                    t_walk0, x_walk0 = t, sim.ground_truth()[0][0]
            ctrl.async_mpc.wait_until_fresh(t, max_staleness=0.06)
            imu = sim.imu()
            qj, dqj = sim.joint_states()
            flags = sim.contact_flags_by_side("left_ankle_link", "right_ankle_link")
            c = ctrl.update_from_sensors(
                t, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
                contact_flags_meas=flags,
            )
            sim.apply_command(c)
            sim.step(substeps)
            if not ctrl.safe:
                break
        pos = sim.ground_truth()[0]
        est_err = np.linalg.norm(ctrl.estimator.base_position - pos)
    finally:
        ctrl.stop()
    assert ctrl.safe, f"safety stop at t={sim.time:.2f}, base at {pos}"
    assert pos[2] > 0.9, pos
    v_avg = (pos[0] - x_walk0) / (sim.time - t_walk0)
    assert abs(v_avg - cmd_vx) <= 0.3 * cmd_vx, f"v_avg {v_avg:.3f}"
    assert est_err < 0.15, est_err


def test_terrain_scene_stance_smoke():
    """Stance balance on the reference's terrain scene (scene_terrain.xml):
    the flat patch at the origin plus height-field/boxes in the scene —
    verifies the cascade runs against the terrain world model."""
    from bipedal_nmpc.runtime.controller import BipedalController

    if not os.path.exists(MJCF_TERRAIN):
        pytest.skip("terrain scene unavailable")
    iface, sim = _make(MJCF_TERRAIN)
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, sim.rbd_state())
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    for _ in range(int(1.0 / control_dt)):
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        c = ctrl.update(sim.time, rbd)
        sim.apply_command(c)
        sim.step(substeps)
        if not ctrl.safe:
            break
    pos = sim.ground_truth()[0]
    assert ctrl.safe and pos[2] > 0.85, pos


def test_swing_planner_per_phase_terrain_heights():
    """The swing planner consumes per-(foot, phase) lift-off/touch-down
    heights (SwingTrajectoryPlanner.cpp:45-246 terrain inputs): splines must
    start/end at the supplied terrain heights, not at 0."""
    import jax.numpy as jnp

    from bipedal_nmpc.gait.mode_schedule import ModeSchedule
    from bipedal_nmpc.gait.swing import SwingConfig, plan_swing_table

    cfg = SwingConfig(
        lift_off_velocity=0.05,
        touch_down_velocity=-0.1,
        swing_height=0.08,
        touchdown_after_horizon=0.2,
        swing_time_scale=0.15,
    )
    # LF swing between two stances: legs {0,1} swing during mode RF(2)
    schedule = ModeSchedule(event_times=[0.3, 0.65], mode_sequence=[3, 2, 3])
    n_phases = 3
    lift = np.zeros((4, n_phases))
    touch = np.zeros((4, n_phases))
    lift[0, :] = 0.05  # left toe lifts off a 5 cm step
    touch[0, :] = 0.12  # ... and lands on a 12 cm step
    table = plan_swing_table(
        cfg, schedule, max_phases=8, lift_off_heights=lift, touch_down_heights=touch
    )
    # contact 0, swing phase index 1: spline starts at the lift-off height,
    # ends at the touch-down height, apex above both
    z0 = float(table.z_position(0, 1, jnp.asarray(0.301)))
    z1 = float(table.z_position(0, 1, jnp.asarray(0.649)))
    zmid = float(table.z_position(0, 1, jnp.asarray(0.475)))
    assert abs(z0 - 0.05) < 0.01, z0
    assert abs(z1 - 0.12) < 0.01, z1
    assert zmid > 0.12, zmid
