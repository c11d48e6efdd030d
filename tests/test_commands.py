"""Live command channel (VERDICT round-1 item #8): re-target gait and
cmd_vel on a RUNNING loop without re-instantiating anything
(GaitKeyboardPublisher.cpp:46-96 + TargetTrajectoriesPublisher.cpp:40-100
semantics through runtime/commands.py)."""
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(scope="module")
def g1_iface():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("g1")


def test_command_router_parsing(g1_iface):
    from bipedal_nmpc.runtime.commands import CommandRouter
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner

    iface = g1_iface
    mpc = MpcRunner(iface)
    x0 = np.asarray(iface.initial_state)
    router = CommandRouter(mpc, iface, observation=lambda: (0.0, x0))

    assert "trot" in router.handle("list")
    assert "unknown gait" in router.handle("gait no_such_gait")
    assert "unknown command" in router.handle("frobnicate")
    assert "bad arguments" in router.handle("cmd_vel not_a_number")
    assert router.handle("") == ""

    # gait splice lands in the schedule
    n_events_before = len(mpc.rm.gait_schedule.get_mode_schedule(0.0, 3.0).event_times)
    assert router.handle("gait trot") == "gait -> trot"
    n_events_after = len(mpc.rm.gait_schedule.get_mode_schedule(0.0, 3.0).event_times)
    assert n_events_after > n_events_before

    # cmd_vel lands in the target trajectory (forward velocity pinned)
    assert "cmd_vel" in router.handle("cmd_vel 0.4 0")
    assert mpc.rm.target.states[0][0] == pytest.approx(0.4, abs=1e-9)
    # goal + stop parse and apply
    assert "goal" in router.handle("goal 1.0 0.0 0.0")
    assert "holding" in router.handle("stop")


def test_mid_run_retarget_dummy_loop():
    """Scripted stance -> trot (+cmd_vel) -> stance on one uninterrupted
    dummy loop: commands mutate the running MPC via the router only.

    Runs in float32, the dtype the card runs.  In float64 the stage KKT's
    dual regularization (1e-9) leaves the stance rows' rank deficiency
    (toe + heel of one rigid foot) nearly unregularized, and the G1
    stand-in's yaw diverges once it walks under the 400 Hz feedback
    policy (measured at 0.2-0.4 m/s; an open item in ROADMAP.md)."""
    import jax

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.commands import CommandRouter
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner
    from bipedal_nmpc.sim.dummy_loop import run_dummy_loop

    with jax.enable_x64(False):
        _retarget_dummy_loop(make_interface_for("g1"), CommandRouter, MpcRunner, run_dummy_loop)


def _retarget_dummy_loop(iface, CommandRouter, MpcRunner, run_dummy_loop):
    mpc = MpcRunner(iface)
    x0 = np.asarray(iface.initial_state)

    latest = {"t": 0.0, "x": x0}
    router = CommandRouter(
        mpc, iface, observation=lambda: (latest["t"], latest["x"])
    )
    script = {0.3: "gait trot", 0.35: "cmd_vel 0.4 0", 1.5: "gait stance", 1.55: "stop"}
    fired = []

    def on_step(t, x):
        latest["t"], latest["x"] = t, np.asarray(x)
        for when in sorted(script):
            if when not in fired and t >= when:
                ack = router.handle(script[when])
                assert "unknown" not in ack and "bad" not in ack, ack
                fired.append(when)

    res = run_dummy_loop(iface, mpc, jnp.asarray(x0), duration=2.2, on_step=on_step)
    assert len(fired) == 4
    # walked forward during the trot window, then held after stance
    dx_walk = res.states[np.searchsorted(res.times, 1.5), 6] - res.states[0, 6]
    assert dx_walk > 0.15, dx_walk
    dx_hold = res.states[-1, 6] - res.states[np.searchsorted(res.times, 1.8), 6]
    assert abs(dx_hold) < 0.08, dx_hold
    # final mode is stance again (all four contacts planned down)
    flags = np.asarray(mpc.last_frozen.gait.contact_flags_at(jnp.asarray(res.times[-1])))
    np.testing.assert_array_equal(flags, np.ones(4))
    assert np.all(np.isfinite(res.states))

def test_runtime_reconfigure_live_controller(g1_iface):
    """dynamic_reconfigure parity (BipedalController.cpp:407-478): change a
    WBC task weight and per-motor PD gains on a RUNNING controller and
    observe the behavior change on the very next tick."""
    from bipedal_nmpc.runtime.commands import CommandRouter
    from bipedal_nmpc.runtime.controller import BipedalController, ControllerConfig

    iface = g1_iface
    ctrl = BipedalController(iface, ControllerConfig())
    router = CommandRouter(ctrl, iface, observation=lambda: ctrl.last_observation)

    x0 = np.asarray(iface.initial_state)
    nj = iface.info.nj
    rbd = np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(6 + nj)])
    # make the desired/measured sides disagree so the weight actually binds
    rbd_off = rbd.copy()
    rbd_off[3:6] += np.array([0.02, -0.01, 0.015])
    ctrl.starting(0.0, jnp.asarray(rbd))
    cmd0 = ctrl.update(0.0, jnp.asarray(rbd_off))

    # ---- live PD gain change, left/right mirrored by substring match
    ack = router.handle("gain hip_pitch 120 7")
    assert "2 joints" in ack, ack
    cmd1 = ctrl.update(0.002, jnp.asarray(rbd_off))
    names = list(iface.task.joint_names)
    for j, nm in enumerate(names):
        if "hip_pitch" in nm:
            assert cmd1.kp[j] == 120.0 and cmd1.kd[j] == 7.0
        else:
            assert cmd1.kp[j] == ctrl.cfg.joint_kp

    # ---- live WBC weight change alters the torque on the same state
    tau_before = ctrl.update(0.004, jnp.asarray(rbd_off)).tau_ff.copy()
    ack = router.handle("wbc_weight baseAccel 200")
    assert "baseAccel" in ack, ack
    assert ctrl.wbc_cfg.weight_base_accel == 200.0
    tau_after = ctrl.update(0.006, jnp.asarray(rbd_off)).tau_ff
    assert np.max(np.abs(tau_after - tau_before)) > 1e-3, (tau_before, tau_after)
    # bad weight name is survivable
    assert "bad arguments" in router.handle("wbc_weight nope 1.0") or "unknown" in router.handle("wbc_weight nope 1.0")
