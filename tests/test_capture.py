"""Capture-point step placement (config.loader.CaptureConfig).

The reference never implemented stepping balance for its line-footed robots
(OpenLoong, Hunter) — lateral capture stepping is an authored extension:
swing-leg hip-roll joint references are biased toward the instantaneous
capture point at every replan (solver.sqp.build_refs dq_swing hook +
runtime.mpc_runner._capture_dq).
"""
import numpy as np
import pytest

import jax.numpy as jnp


def test_build_refs_dq_swing_masks_by_leg(h1_model, h1_info):
    """dq_swing offsets apply to x_nom's joint block only on nodes where
    that leg is in swing; stance-node references stay untouched."""
    from bipedal_nmpc.gait.mode_schedule import GaitSchedule, ModeSchedule, ModeSequenceTemplate
    from bipedal_nmpc.gait.swing import SwingConfig, plan_swing_table
    from bipedal_nmpc.reference.manager import ReferenceManager
    from bipedal_nmpc.reference.target import TargetTrajectories
    from bipedal_nmpc.solver.sqp import build_refs

    nj = h1_info.nj
    x0 = np.zeros(12 + nj)
    x0[8] = 0.9
    gait = GaitSchedule(
        ModeSchedule([], [3]),
        ModeSequenceTemplate([0.0, 0.35, 0.7], [1, 2]),  # LF / RF trot
        0.4,
    )
    rm = ReferenceManager(
        gait_schedule=gait,
        swing_config=SwingConfig(),
        target=TargetTrajectories(
            times=np.array([0.0]), states=x0[None, :].copy(),
            inputs=np.zeros((1, h1_info.input_dim)),
        ),
        horizon=1.0,
        num_intervals=20,
        max_phases=24,
    )
    rm.set_gait(ModeSequenceTemplate([0.0, 0.35, 0.7], [1, 2]), start_time=0.0)
    fz = rm.freeze(0.0)
    t_nodes = jnp.asarray(fz.t_nodes)

    base = build_refs(h1_info, fz.gait, fz.swing, fz.target, t_nodes)
    dq = jnp.zeros((2, nj)).at[0, 1].set(0.2).at[1, 6].set(-0.1)
    shifted = build_refs(h1_info, fz.gait, fz.swing, fz.target, t_nodes, dq)

    flags = np.asarray(base.contact_flags)
    left_swing = 1.0 - flags[:, :2].max(axis=1)
    right_swing = 1.0 - flags[:, 2:].max(axis=1)
    got = np.asarray(shifted.x_nom[:, 12:] - base.x_nom[:, 12:])
    want = left_swing[:, None] * np.asarray(dq[0]) + right_swing[:, None] * np.asarray(dq[1])
    np.testing.assert_allclose(got, want, atol=1e-12)
    # both legs actually swing somewhere in this horizon
    assert left_swing.max() == 1.0 and right_swing.max() == 1.0
    # everything else is untouched
    np.testing.assert_allclose(
        np.asarray(shifted.x_nom[:, :12]), np.asarray(base.x_nom[:, :12]), atol=0
    )


def test_capture_config_parsed_for_openloong_and_hunter():
    from bipedal_nmpc.robots import get_assets
    from bipedal_nmpc.config.loader import load_task_config

    for robot, lname in (("openloong", "J_hip_l_roll"), ("hunter", "leg_l1_joint")):
        a = get_assets(robot)
        if a.missing_files():
            pytest.skip(f"{robot} assets unavailable (set $BIPEDAL_ASSETS)")
        task = load_task_config(
            a.task_info, a.reference_info, a.gait_info, a.overrides_info, a.extra_gait_info
        )
        cap = task.capture
        assert cap is not None, robot
        assert task.joint_names[cap.left_index] == lname
        assert cap.kv > 0.0 and cap.max_offset > 0.0


def test_capture_dq_direction():
    """A rightward (−y) velocity error must bias BOTH hip-roll references
    toward −roll (feet step toward −y, under the +x axis convention), and
    the offset saturates at max_offset."""
    from bipedal_nmpc.config.loader import CaptureConfig
    from bipedal_nmpc.runtime.mpc_runner import capture_dq_from_state

    cap = CaptureConfig(left_index=1, right_index=6, kp=0.8, kv=0.4, max_offset=0.25)
    nj = 10
    x = jnp.zeros(24)
    x = x.at[1].set(-0.5)  # vcom_y = -0.5 m/s, zero position error, yaw 0
    x_ref = jnp.zeros(24)
    dq = capture_dq_from_state(cap, nj, x, x_ref)
    assert dq.shape == (2, nj)
    assert float(dq[0, 1]) == pytest.approx(-0.2, abs=1e-9)
    assert float(dq[1, 6]) == pytest.approx(-0.2, abs=1e-9)
    assert float(jnp.count_nonzero(dq)) == 2
    # saturation
    x = x.at[1].set(-5.0)
    dq = capture_dq_from_state(cap, nj, x, x_ref)
    assert float(dq[0, 1]) == pytest.approx(-0.25, abs=1e-9)
    # yaw rotation: at yaw = pi/2, a world +x velocity is body -y
    x2 = jnp.zeros(24).at[0].set(0.5).at[9].set(np.pi / 2)
    dq2 = capture_dq_from_state(cap, nj, x2, x_ref)
    assert float(dq2[0, 1]) == pytest.approx(-0.2, abs=1e-6)


def test_capture_touchdown_sync_lipm_propagation():
    """touchdownSync (LegLogic-powered lead, VERDICT r4 next-step #6): the
    per-leg capture error is LIPM-propagated to that leg's next touchdown.
    A leg touching down NOW gets the instantaneous bias; a leg touching
    down later gets the cosh/sinh-amplified error; zero error stays zero."""
    from bipedal_nmpc.config.loader import CaptureConfig
    from bipedal_nmpc.gait.mode_schedule import ModeSchedule, freeze_mode_schedule
    from bipedal_nmpc.runtime.mpc_runner import capture_dq_from_state

    cap = CaptureConfig(
        left_index=1, right_index=6, kp=0.0, kv=0.4, max_offset=10.0,
        touchdown_sync=True,
    )
    nj = 10
    # left touches down at t=0.101 (dt ~ 0), right at t=0.4 (dt = 0.3)
    sched = ModeSchedule([0.101, 0.4, 0.7], [2, 1, 2, 3])
    table = freeze_mode_schedule(sched, max_phases=8)
    x = jnp.zeros(24).at[1].set(-0.5).at[8].set(0.9)  # vy error, z for w
    x_ref = jnp.zeros(24).at[8].set(0.9)
    dq = capture_dq_from_state(cap, nj, x, x_ref, table, jnp.asarray(0.1))
    w = np.sqrt(9.81 / 0.9)
    # left: dt ~ 0.001 -> essentially the instantaneous -0.2
    assert float(dq[0, 1]) == pytest.approx(0.4 * -0.5, rel=1e-2)
    # right: dt = 0.3 -> edot_td = e w sinh + edot cosh, e = 0
    edot_td = -0.5 * np.cosh(w * 0.3)
    assert float(dq[1, 6]) == pytest.approx(0.4 * edot_td, rel=1e-6)
    assert abs(float(dq[1, 6])) > abs(float(dq[0, 1]))  # amplified
    # zero error -> zero bias regardless of timing
    dq0 = capture_dq_from_state(cap, nj, x_ref, x_ref, table, jnp.asarray(0.1))
    np.testing.assert_allclose(np.asarray(dq0), 0.0, atol=1e-12)


def test_build_refs_weight_shift(h1_info):
    """weightShift: the base-y reference moves toward the single-support
    stance foot per node (+amp in LF, -amp in RF, 0 in double support),
    rotated to world by the node's yaw reference."""
    from bipedal_nmpc.gait.mode_schedule import ModeSchedule, freeze_mode_schedule
    from bipedal_nmpc.gait.swing import SwingConfig, plan_swing_table
    from bipedal_nmpc.reference.target import TargetTrajectories
    from bipedal_nmpc.solver.sqp import build_refs

    nj = h1_info.nj
    x0 = np.zeros(12 + nj)
    x0[8] = 0.9
    sched = ModeSchedule([0.1, 0.4, 0.7], [3, 1, 2, 3])  # STANCE, LF, RF, STANCE
    gait_t = freeze_mode_schedule(sched, max_phases=8)
    swing_t = plan_swing_table(SwingConfig(), sched, 8)
    tgt = TargetTrajectories(
        times=np.array([0.0]), states=x0[None, :].copy(),
        inputs=np.zeros((1, h1_info.input_dim)),
    ).freeze(4)
    t_nodes = jnp.asarray([0.2, 0.5, 0.8, 0.9])  # LF, RF, STANCE nodes
    base = build_refs(h1_info, gait_t, swing_t, tgt, t_nodes)
    ws = build_refs(h1_info, gait_t, swing_t, tgt, t_nodes, weight_shift=0.03)
    dy = np.asarray(ws.x_nom[:, 7] - base.x_nom[:, 7])
    np.testing.assert_allclose(dy, [0.03, -0.03, 0.0], atol=1e-12)
    # x untouched at yaw 0
    np.testing.assert_allclose(
        np.asarray(ws.x_nom[:, 6]), np.asarray(base.x_nom[:, 6]), atol=1e-12
    )
