"""On-device physics backend (sim/jax_physics.py) + batched closed loop
(sim/batch_loop.py) — the MJX-role layer (SURVEY §7.1 layer 8, VERDICT r1
item #2).  Behavioral validation: ballistic motion, static force balance,
drop-settle, and the full MPC->WBC->physics cascade holding stance balance
for a randomized batch in ONE jitted program."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(scope="module")
def h1():
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.robots import get_assets

    if get_assets("h1").missing_files():
        pytest.skip("h1 assets unavailable (set $BIPEDAL_ASSETS)")
    return make_interface_for("h1")


@pytest.fixture(scope="module")
def g1():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("g1")


def _roll(model, info, cfg, st, n, q_des, kp, kd):
    import bipedal_nmpc.sim.jax_physics as JP

    @partial(jax.jit, static_argnums=(1,))
    def run(st, n):
        def body(s, _):
            tau = JP.hybrid_pd_torque_explicit(q_des, 0.0, kp, kd, 0.0, s.q[6:])
            s2, f = JP.sim_step(model, info, cfg, s, tau, joint_damping=kd)
            return s2, jnp.array([s2.q[2], jnp.abs(s2.q[4]) + jnp.abs(s2.q[5]), jnp.sum(f[:, 2])])
        return jax.lax.scan(body, st, None, length=n)

    return run(st, n)


def test_free_fall_ballistic(g1):
    """No contact, no torque: the base integrates exactly ballistically."""
    import bipedal_nmpc.sim.jax_physics as JP

    model, info = g1.model, g1.info
    cfg = JP.JaxSimConfig()
    st = JP.initial_sim_state(model, info, jnp.asarray(g1.initial_state))
    st = st._replace(q=st.q.at[2].set(2.0))
    T = 0.3
    st2, _ = _roll(model, info, cfg, st, int(T / cfg.dt),
                   jnp.asarray(g1.initial_state[12:]), 0.0, 0.0)
    dz = float(st2.q[2]) - 2.0
    # semi-implicit Euler: dz = -g dt^2 n(n+1)/2
    n = int(T / cfg.dt)
    expected = -9.81 * cfg.dt**2 * n * (n + 1) / 2
    assert abs(dz - expected) < 1e-6, (dz, expected)
    assert float(jnp.abs(st2.v[3:6]).max()) < 1e-10  # no phantom rotation


def test_statue_static_force_balance(g1):
    """Stiff PD hold: the robot stands; total normal force == weight."""
    import bipedal_nmpc.sim.jax_physics as JP

    model, info = g1.model, g1.info
    cfg = JP.JaxSimConfig(torque_limit=500.0)
    x0 = jnp.asarray(g1.initial_state)
    st = JP.initial_sim_state(model, info, x0)
    st = st._replace(q=st.q.at[2].add(0.01))  # drop in from 1 cm
    st2, tr = _roll(model, info, cfg, st, 3000, x0[12:], 3000.0, 100.0)
    tr = np.asarray(tr)
    weight = float(info.robot_mass) * 9.81
    assert tr[-1, 0] > 0.9 * float(x0[8]), tr[-1]  # standing height held
    assert tr[-1, 1] < 0.1, tr[-1]  # upright
    assert abs(tr[-1, 2] - weight) < 0.02 * weight, (tr[-1, 2], weight)
    # settled: velocity transients decayed
    assert float(jnp.abs(st2.v).max()) < 0.15


def test_sticking_feet_do_not_creep(g1):
    """The anchored tangential model gives true stiction: after the initial
    elastic settle (the anchor spring deflects a few mm under the standing
    leg-spread forces — compliance, not slip), the feet stop moving.  A
    viscous-only tangential model creeps without bound instead."""
    import bipedal_nmpc.sim.jax_physics as JP
    from bipedal_nmpc.model.kinematics import forward_kinematics

    model, info = g1.model, g1.info
    cfg = JP.JaxSimConfig(torque_limit=500.0)
    x0 = jnp.asarray(g1.initial_state)
    st = JP.initial_sim_state(model, info, x0)
    pts0 = np.asarray(JP._contact_points(model, info, forward_kinematics(model, st.q)))
    st1, _ = _roll(model, info, cfg, st, 3000, x0[12:], 3000.0, 100.0)
    pts1 = np.asarray(JP._contact_points(model, info, forward_kinematics(model, st1.q)))
    st2, _ = _roll(model, info, cfg, st1, 1500, x0[12:], 3000.0, 100.0)
    pts2 = np.asarray(JP._contact_points(model, info, forward_kinematics(model, st2.q)))
    # bounded elastic deflection from the start...
    assert np.abs(pts2[:, :2] - pts0[:, :2]).max() < 8e-3, pts2 - pts0
    # ...and motion has died out after the 3 s settle (measured: 1.5e-4 over
    # this window, still decaying; viscous-only friction never stops)
    assert np.abs(pts2[:, :2] - pts1[:, :2]).max() < 3e-4, pts2 - pts1


def test_batched_cascade_stance(h1):
    """Full MPC -> policy -> WBC -> PD -> physics cascade, batched and
    domain-randomized, one jitted program: every scenario stays upright."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.05, sqp_iterations=1)
    )
    cfg = BatchLoopConfig(duration=0.4)
    run = make_batched_closed_loop(iface, cfg)
    X = randomized_initial_states(iface, 4, seed=0)
    res = run(X)
    z_min = np.asarray(res.base_z_min)
    tilt = np.asarray(res.tilt_max)
    assert np.all(np.isfinite(z_min)), z_min
    assert np.all(z_min > 0.80), z_min
    assert np.all(tilt < 0.35), tilt
    assert np.all(np.isfinite(np.asarray(res.defect_last)))


def test_batched_cascade_standing_trot(h1):
    """The on-device cascade *steps*: a standing-trot gait spliced into the
    frozen tables makes the jitted episode lift and re-plant feet while
    staying upright — batched locomotion with zero host round trips."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.05, sqp_iterations=1)
    )
    cfg = BatchLoopConfig(duration=1.0)
    run = make_batched_closed_loop(iface, cfg, gait="standing_trot", gait_at=0.2)
    X = jnp.asarray(np.asarray(iface.initial_state)[None])
    res = run(X)
    assert float(res.base_z_min[0]) > 0.85, np.asarray(res.base_z_min)
    assert float(res.tilt_max[0]) < 0.6, np.asarray(res.tilt_max)
    assert np.isfinite(float(res.defect_last[0]))


def test_batched_cascade_walks(h1):
    """The on-device cascade WALKS: trot gait + a cmd_vel target that is
    re-computed from the current observation at every replan inside the
    jitted scan (the host loop's TargetTrajectoriesPublisher.cpp:77-100
    retarget cadence — a target frozen once at t=0 leaves the robot
    trotting in place).  H1 covers >= 0.5 m in 3 s at cmd_vel 0.3 m/s
    after the gait-start transient, entirely on device."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.02, sqp_iterations=1)
    )
    cfg = BatchLoopConfig(duration=3.0)
    run = make_batched_closed_loop(
        iface, cfg, gait="trot", gait_at=0.2, cmd_vel=(0.3, 0.0, 0.0, 0.0)
    )
    X = jnp.asarray(np.asarray(iface.initial_state)[None])
    res = run(X)
    q = np.asarray(res.final_state.q)
    assert q[0, 0] > 0.5, q[0, :3]  # advanced (measured ~1.0 m)
    assert q[0, 2] > 0.85, q[0, :3]  # upright at the end
    assert float(res.base_z_min[0]) > 0.75, float(res.base_z_min[0])
    assert float(res.tilt_max[0]) < 0.8, float(res.tilt_max[0])
    assert np.isfinite(float(res.defect_last[0]))


def test_batched_cascade_walks_randomized(h1):
    """Domain-randomized batched WALKING with a survival-rate assertion
    (VERDICT r3 next-step #4): the BASELINE config-5 scenario axis was
    previously only exercised in stance.  B=8 randomized initial states
    (base pose + joint jitter, sim/batch_loop.py::randomized_initial_states)
    walk the full on-device cascade for 3 s at cmd 0.3; survival = upright
    (final z > 0.8, tilt < 0.8) AND progressed (x > 0.3*cmd*T).  The
    survival-vs-jitter sweep at B=64 is tools/scenario_survival.py.

    Floor provenance (re-pinned 2026-08-22, VERDICT r4 weak #1): the H1
    captureStepping reflex shifted this fixed-seed draw from 3/8 to 2/8
    surviving (4/8 upright both ways) and the round-4 floor went stale/red.
    The reflex was then A/B'd at population scale under a MATCHED config
    (freeze-on-fall guard, f32 dots on chip / f64 on CPU): capture ON wins
    or ties at every jitter scale on the chip (0.625/0.531/0.500/0.500 vs
    0.609/0.516/0.406/0.406, B=64) and lifts CPU-f64 B=32 survival 0.625 ->
    0.719 — the B=8 regression is a small-sample artifact, so capture stays
    ON and the floors re-pin to the measured 2/8 surviving, 4/8 upright
    (one scenario stays upright but walks backward).  Regression to
    near-zero is what these catch."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.02, sqp_iterations=1)
    )
    run = make_batched_closed_loop(
        iface, BatchLoopConfig(duration=3.0), gait="trot", gait_at=0.2,
        cmd_vel=(0.3, 0.0, 0.0, 0.0),
    )
    X = randomized_initial_states(iface, 8, seed=7)
    res = run(X)
    q = np.asarray(res.final_state.q)
    upright = (q[:, 2] > 0.8) & (np.asarray(res.tilt_max) < 0.8)
    progressed = q[:, 0] > 0.3 * 0.3 * 3.0
    survival = np.mean(upright & progressed)
    # freeze-on-fall guard: every lane ends finite even after falling
    assert np.all(np.isfinite(q)), q[:, 2]
    assert np.mean(upright) >= 0.5 and survival >= 0.25, (
        f"survival {survival:.2f}, upright {np.mean(upright):.2f}; "
        f"z={q[:, 2].round(2)}, x={q[:, 0].round(2)}, "
        f"tilt={np.asarray(res.tilt_max).round(2)}"
    )


def test_batched_cascade_lateral_and_yaw(h1):
    """cmd_vel envelope beyond forward walking, on device: a lateral
    command moves the batch sideways and a forward+yaw command arcs it,
    both upright throughout (measured 2026-08-21: lateral y +0.52 m;
    walking turn yaw +0.52 rad with x +0.70 m in 3 s.  In-place spinning
    is NOT asserted: toe/heel point contacts must stick-slip torsionally
    to pivot, which the anchored-friction plant makes chaotic — an
    aggressive in-place yaw command can spin either way)."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.02, sqp_iterations=1)
    )
    X = jnp.asarray(np.asarray(iface.initial_state)[None])

    run = make_batched_closed_loop(
        iface, BatchLoopConfig(duration=3.0), gait="trot", gait_at=0.2,
        cmd_vel=(0.0, 0.2, 0.0, 0.0),
    )
    res = run(X)
    q = np.asarray(res.final_state.q)
    assert q[0, 1] > 0.3, q[0, :3]  # moved laterally with the command
    assert q[0, 2] > 0.85 and float(res.base_z_min[0]) > 0.8

    run = make_batched_closed_loop(
        iface, BatchLoopConfig(duration=3.0), gait="trot", gait_at=0.2,
        cmd_vel=(0.25, 0.0, 0.0, 0.3),
    )
    res = run(X)
    q = np.asarray(res.final_state.q)
    assert q[0, 3] > 0.3, q[0, 3]  # turned with the yaw command (arc walk)
    assert q[0, 0] > 0.4, q[0, :3]  # while advancing
    assert q[0, 2] > 0.85 and float(res.base_z_min[0]) > 0.8


def test_on_device_vs_host_mujoco_stance_parity(h1):
    """Single-scenario behavioral parity with the host MuJoCo loop (the
    VERDICT item-2 'MJX run matches host loop' criterion, adapted: penalty
    contact cannot bit-match an LCP solver, so the claim is the controlled
    *behavior* — same cascade, both plants hold the same stance envelope)."""
    import os

    mjcf = os.path.join(
        os.environ.get("BIPEDAL_ASSETS", ""),
        "bipedal_robot_example/unitree_h1/h1_description/mjcf/scene.xml",
    )
    if not os.path.exists(mjcf):
        pytest.skip("H1 MJCF unavailable")
    pytest.importorskip("mujoco")
    from bipedal_nmpc.runtime.controller import BipedalController
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.05, sqp_iterations=1)
    )
    # on-device plant
    run = make_batched_closed_loop(iface, BatchLoopConfig(duration=0.6))
    res = run(jnp.asarray(np.asarray(iface.initial_state)[None]))
    z_dev = float(res.final_state.q[0, 2])

    # host MuJoCo plant under the full controller (same robot, same target)
    sim = MujocoSimBackend(mjcf, list(h1.task.joint_names), MujocoSimConfig())
    x0 = h1.initial_state
    upper = dict(zip(h1.task.upper_joint_names, h1.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    ctrl = BipedalController(h1)
    ctrl.starting(sim.time, sim.rbd_state())
    substeps = max(1, int(round(0.002 / sim.timestep)))
    for _ in range(int(0.6 / 0.002)):
        cmd = ctrl.update(sim.time, sim.rbd_state(last_yaw=ctrl.last_yaw))
        sim.apply_command(cmd)
        sim.step(substeps)
    z_host = sim.ground_truth()[0][2]

    assert ctrl.safe
    # same standing envelope on both plants (few-cm agreement)
    assert abs(z_dev - z_host) < 0.06, (z_dev, z_host)
    assert float(res.tilt_max[0]) < 0.15


def test_batched_cascade_hunter_walks():
    """Hunter WALKS in the on-device cascade (round 4): the implicit-damped
    compliant plant has neither the sole-box inconsistency nor the
    chatter-pump of the explicit MuJoCo PD (its contact points ARE the
    model's frames and damping integrates implicitly), so hunter works
    without the armature fix the MuJoCo scene needed.  Measured 2026-08-21:
    0.45 m in ~2.7 s of walking at cmd 0.2, z_min 0.589, tilt_max 0.096 —
    all four robots now close the loop on the device plant too."""
    import os

    from conftest import REFERENCE_ASSETS
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )

    urdf = os.path.join(
        REFERENCE_ASSETS,
        "bipedal_robot_example/hunter/legged_hunter_description/urdf/hunter.urdf",
    )
    if not os.path.exists(urdf):
        pytest.skip("hunter URDF unavailable")
    iface = make_interface_for("hunter")
    iface = dataclasses.replace(
        iface, settings=dataclasses.replace(iface.settings, dt=0.02, sqp_iterations=1)
    )
    run = make_batched_closed_loop(
        iface, BatchLoopConfig(duration=3.0), gait="fast_trot", gait_at=0.3,
        cmd_vel=(0.2, 0.0, 0.0, 0.0),
    )
    X = jnp.asarray(np.asarray(iface.initial_state)[None])
    res = run(X)
    q = np.asarray(res.final_state.q)
    assert q[0, 0] > 0.25, q[0, :3]  # walked (measured 0.45 m)
    assert q[0, 2] > 0.5 and float(res.base_z_min[0]) > 0.5, q[0, :3]
    assert float(res.tilt_max[0]) < 0.4, float(res.tilt_max[0])
    assert np.isfinite(float(res.defect_last[0]))


def test_freeze_on_fall_guard(h1):
    """Freeze-on-fall (VERDICT r4 weak #3 / next-step #3): a lane that falls
    is detected (fell=True) and HELD at its last finite snapshot — final
    state finite, below the fall threshold, no NaN pollution — while a
    nominal lane in the same batch is untouched (fell=False, stands).  The
    guard replaces the legacy keep-integrating semantics whose post-fall
    blowups were the entire finite_frac<1 residual of an earlier sweep."""
    from bipedal_nmpc.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
    )

    iface = dataclasses.replace(
        h1, settings=dataclasses.replace(h1.settings, dt=0.05, sqp_iterations=1)
    )
    run = make_batched_closed_loop(iface, BatchLoopConfig(duration=0.4))
    x0 = np.asarray(iface.initial_state)
    doomed = x0.copy()
    doomed[10] = 1.2  # massive initial pitch: unrecoverable, falls in <0.4 s
    X = jnp.asarray(np.stack([x0, doomed]))
    res = run(X)
    fell = np.asarray(res.fell)
    q = np.asarray(res.final_state.q)
    assert not fell[0] and fell[1], fell
    # nominal lane unaffected by sharing a batch with a frozen lane
    assert q[0, 2] > 0.85 and float(res.tilt_max[0]) < 0.35
    # fallen lane: every field finite (the guard's whole point)...
    assert np.all(np.isfinite(q[1])) and np.all(np.isfinite(np.asarray(res.final_state.v)[1]))
    assert np.isfinite(float(res.defect_last[1]))
    # ...and held at a genuinely fallen snapshot
    z_fall = 0.5 * x0[8]
    assert q[1, 2] < z_fall + 0.05 or abs(q[1, 4]) + abs(q[1, 5]) > 1.0, q[1, :6]
