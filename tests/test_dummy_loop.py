"""Planner-only closed-loop tests (dummy MRT loop, milestone-1 e2e slice).

This is the reference's standard verification harness: MPC replanning at
50 Hz against its own model integrated at 400 Hz (SURVEY.md §3.4 / §7.2,
BASELINE config "H1 flat-ground trot, single-scenario SQP NMPC, 1 s horizon").
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REFERENCE_ASSETS, "bipedal_robot_example")),
    reason="reference assets unavailable",
)


@pytest.fixture(scope="module")
def h1_iface():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("h1")


def test_h1_trot_dummy_loop(h1_iface):
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.sim.dummy_loop import run_dummy_loop

    iface = h1_iface
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    x0 = jnp.asarray(iface.initial_state)
    res = run_dummy_loop(iface, mpc, x0, duration=1.0, mrt_frequency=400.0, mpc_frequency=50.0)

    assert np.all(np.isfinite(res.states))
    base = res.states[:, 6:12]
    # base height holds near the com target through gait switching
    np.testing.assert_allclose(base[:, 2], 0.93, atol=0.05)
    # roll/pitch stay small (the robot does not fall in its own model)
    assert np.abs(base[:, 4:]).max() < 0.15
    # normalized momentum bounded
    assert np.abs(res.states[:, 0:6]).max() < 1.0
    # MPC latency measured (CPU numbers; the device bench is bench.py)
    assert res.mpc_stats["count"] >= 40


def test_h1_cmd_vel_tracking(h1_iface):
    """Forward walk command: the dummy loop must make forward progress at
    roughly the commanded speed (cmd_vel -> target trajectory path)."""
    from bipedal_nmpc.reference.target import cmd_vel_to_target_trajectories
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.sim.dummy_loop import run_dummy_loop

    iface = h1_iface
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    x0 = np.asarray(iface.initial_state)
    cmd = np.array([0.4, 0.0, 0.0, 0.0])  # 0.4 m/s forward
    mpc.rm.set_target(
        cmd_vel_to_target_trajectories(cmd, 0.0, x0, iface.command_config, iface.info.input_dim)
    )
    res = run_dummy_loop(iface, mpc, jnp.asarray(x0), duration=1.0)
    dx = res.states[-1, 6] - res.states[0, 6]
    # some forward progress toward 0.4 m/s (transient from standstill)
    assert dx > 0.1, dx
    # lateral sway (weight shift over the stance foot) is expected in trot
    assert np.abs(res.states[:, 7]).max() < 0.25
    assert np.all(np.isfinite(res.states))


def test_h1_trot_golden_regression(h1_iface):
    """Golden-trajectory regression anchor (SURVEY §4 implication): the 0.5 s
    H1-trot dummy loop endpoint is pinned so solver/model changes that shift
    the closed-loop behavior get flagged.  Regenerate the values deliberately
    when an intentional change lands (scripts in tests/README note)."""
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.sim.dummy_loop import run_dummy_loop

    iface = h1_iface
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    res = run_dummy_loop(iface, mpc, jnp.asarray(iface.initial_state), duration=0.5)
    # regenerated 2026-08-22: H1 gained a captureStepping block in
    # configs/h1/overrides.info (round-4 survival work) — trot weight-shift
    # sway crosses the capture velocity deadband (0.12 m/s) for brief
    # stretches, so the hip-roll recovery bias now perturbs the nominal
    # endpoint slightly (max shift 0.023 on base roll; z unchanged at 0.928).
    # Previous regeneration 2026-08-20: upper-body joints weld at the held
    # pose (defaultUpperJointState) instead of zero — see make_interface.
    golden = np.array(
        [
            -0.1907469608, -0.4667687502, -0.1135256063, -0.0032729543,
            -0.0038241002, 0.0006070052, -0.0556667631, -0.1030173713,
            0.9279477698, 0.0113393959, -0.0128184404, 0.0501781959,
        ]
    )
    np.testing.assert_allclose(res.states[-1, :12], golden, atol=2e-3)
