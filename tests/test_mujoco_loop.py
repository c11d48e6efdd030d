"""Full-cascade closed loop in MuJoCo physics (milestone-2 integration).

Equivalent of the reference's bringup_mujoco + restart_mujoco.py manual test
(SURVEY.md §4 item 3): real physics, cheater estimator, MPC -> policy -> WBC
-> hybrid joint PD commands, safety checker in the loop.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

MJCF = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/unitree_h1/h1_description/mjcf/scene.xml"
)
pytestmark = pytest.mark.skipif(not os.path.exists(MJCF), reason="H1 MJCF scene unavailable")


@pytest.fixture(scope="module")
def h1_sim_setup():
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("h1")
    sim = MujocoSimBackend(MJCF, list(iface.task.joint_names), MujocoSimConfig())
    return iface, sim


def _reset(iface, sim):
    x0 = iface.initial_state
    upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        # lift by the sole-geometry penetration depth so the feet start in
        # light contact instead of 1.6 cm into the floor
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )


def _run(iface, sim, ctrl, duration, gait=None, gait_at=1.0):
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    gait_set = False
    for _ in range(int(duration / control_dt)):
        if gait and sim.time > gait_at and not gait_set:
            ctrl.mpc.rm.set_gait(iface.task.gait_library[gait], start_time=sim.time + 0.1)
            gait_set = True
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        cmd = ctrl.update(sim.time, jnp.asarray(rbd))
        assert np.all(np.isfinite(cmd.tau_ff))
        sim.apply_command(cmd)
        sim.step(substeps)
        if not ctrl.safe:
            break
    return sim.ground_truth()[0]


def test_mujoco_stance_balance(h1_sim_setup):
    """Standing balance for 1.5 s of real physics without a safety stop."""
    from bipedal_nmpc.runtime.controller import BipedalController

    iface, sim = h1_sim_setup
    _reset(iface, sim)
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, jnp.asarray(sim.rbd_state()))
    pos = _run(iface, sim, ctrl, 1.5)
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.85, pos


def _run_kalman(iface, sim, ctrl, duration, gait=None, gait_at=1.0, measured_contacts=False):
    """Closed loop driven from IMU + joint sensors through the contact LKF
    (no ground truth on the control path).  measured_contacts=True feeds the
    MuJoCo contact readout instead of the planned gait flags (the
    ContactSensorInterface path the reference never wired)."""
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    gait_set = False
    est_errs = []
    for _ in range(int(duration / control_dt)):
        if gait and sim.time > gait_at and not gait_set:
            ctrl.set_gait(iface.task.gait_library[gait], start_time=sim.time + 0.1)
            gait_set = True
        imu = sim.imu()
        qj, dqj = sim.joint_states()
        flags_meas = (
            sim.contact_flags_by_side("left_ankle_link", "right_ankle_link")
            if measured_contacts
            else None
        )
        cmd = ctrl.update_from_sensors(
            sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
            contact_flags_meas=flags_meas,
        )
        assert np.all(np.isfinite(cmd.tau_ff))
        est_errs.append(
            np.linalg.norm(ctrl.estimator.base_position - sim.ground_truth()[0])
        )
        sim.apply_command(cmd)
        sim.step(substeps)
        if not ctrl.safe:
            break
    return sim.ground_truth()[0], np.asarray(est_errs)


def test_mujoco_stance_kalman(h1_sim_setup):
    """Standing balance with the contact LKF in the loop instead of ground
    truth (the estimator the reference declares but ships empty —
    LinearKalmanFilter.h:27-67; VERDICT round-1 item #3).  Asserts both
    stability and a bounded base-position estimate error."""
    from bipedal_nmpc.runtime.controller import BipedalController, ControllerConfig

    iface, sim = h1_sim_setup
    _reset(iface, sim)
    ctrl = BipedalController(iface, ControllerConfig(estimator="kalman"))
    x0 = iface.initial_state
    imu = sim.imu()
    qj, dqj = sim.joint_states()
    ctrl.starting_from_sensors(
        sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
        base_pos_guess=sim.ground_truth()[0],
    )
    pos, est_errs = _run_kalman(iface, sim, ctrl, 1.5, measured_contacts=True)
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.85, pos
    # estimate stays honest: bounded error throughout, small at the end
    assert est_errs.max() < 0.10, est_errs.max()
    assert est_errs[-1] < 0.05, est_errs[-1]


def test_mujoco_standing_trot_kalman(h1_sim_setup):
    """Standing trot with the LKF in the loop: swing feet inflate their
    process noise and re-converge at touchdown while the robot steps."""
    from bipedal_nmpc.runtime.controller import BipedalController, ControllerConfig

    iface, sim = h1_sim_setup
    _reset(iface, sim)
    ctrl = BipedalController(iface, ControllerConfig(estimator="kalman"))
    imu = sim.imu()
    qj, dqj = sim.joint_states()
    ctrl.starting_from_sensors(
        sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
        base_pos_guess=sim.ground_truth()[0],
    )
    pos, est_errs = _run_kalman(
        iface, sim, ctrl, 3.0, gait="standing_trot", gait_at=1.0, measured_contacts=True
    )
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.85, pos
    assert abs(pos[0]) < 0.3 and abs(pos[1]) < 0.3, pos
    assert est_errs.max() < 0.15, est_errs.max()


def test_mujoco_standing_trot(h1_sim_setup):
    """Full cascade stepping in place: stance settle, then standing_trot gait
    cycles in real physics (BASELINE config: gait switching + physics loop)."""
    from bipedal_nmpc.runtime.controller import BipedalController

    iface, sim = h1_sim_setup
    _reset(iface, sim)
    ctrl = BipedalController(iface)
    ctrl.starting(sim.time, jnp.asarray(sim.rbd_state()))
    pos = _run(iface, sim, ctrl, 3.0, gait="standing_trot", gait_at=1.0)
    assert ctrl.safe, f"safety stop, base at {pos}"
    assert pos[2] > 0.85, pos
    assert abs(pos[0]) < 0.3 and abs(pos[1]) < 0.3, pos  # stays near origin


def test_gazebo_semantics_read_path():
    """Gazebo hardware-sim read-path fidelity (BipedalHWSim.cpp:88-158,
    VERDICT r3 missing #4): finite-differenced joint velocities, IMU
    synthesized from the base link state (not MJCF sensor plugins), and
    one-shot command consumption (stepping without a fresh command zeroes
    the actuation)."""
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.controller import JointCommand
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = make_interface_for("h1")
    sim = MujocoSimBackend(
        MJCF, list(iface.task.joint_names), MujocoSimConfig(gazebo_semantics=True)
    )
    x0 = iface.initial_state
    upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    nj = iface.info.nj
    hold = JointCommand(
        pos_des=np.asarray(x0[12:]), vel_des=np.zeros(nj),
        kp=np.full(nj, 150.0), kd=np.full(nj, 5.0), tau_ff=np.zeros(nj),
    )
    # first read: zero fd velocity by definition
    qj0, dqj0 = sim.joint_states()
    assert np.all(dqj0 == 0.0)
    for _ in range(100):
        sim.apply_command(hold)
        sim.step(2)
    # fd velocities track the simulator's true joint velocities
    qj, dqj_fd = sim.joint_states()
    dqj_true = sim.data.qvel[sim._dadr]
    assert np.max(np.abs(dqj_fd)) < 5.0  # sane magnitudes under a PD hold
    # one more cycle to compare a fresh fd sample against truth
    sim.apply_command(hold)
    sim.step(2)
    _, dqj_fd = sim.joint_states()
    dqj_true = sim.data.qvel[sim._dadr].copy()
    assert np.max(np.abs(dqj_fd - dqj_true)) < 0.5, (dqj_fd, dqj_true)
    # synthesized IMU: quat matches ground truth; accel ~ specific force
    # (gravity-dominated near rest); gyro matches body angular rate
    imu = sim.imu()
    gt_quat = sim.ground_truth()[1]
    assert np.allclose(imu["imu_quat"], gt_quat)
    assert abs(np.linalg.norm(imu["imu_acc"]) - 9.81) < 3.0
    # stale-command safety: stepping WITHOUT a fresh command zeroes ctrl
    sim.apply_command(hold)
    sim.step(2)
    sim.step(2)  # second cycle, no apply_command in between
    leg_ctrl = np.array([sim.data.ctrl[a] for a in sim._act_ids])
    assert np.all(leg_ctrl == 0.0), leg_ctrl
