"""Terrain-aware references (VERDICT r4 next-step #7).

The reference ships a terrain world (scene_terrain.xml) and full per-phase
swing-height plumbing (SwingTrajectoryPlanner.cpp:66-118) but hardcodes
terrainHeight = 0 in its planner (SwitchedModelReferenceManager.cpp:64-71).
Here the loop is closed: sim/terrain.py raycasts the static world into a
height map, and ReferenceManager.freeze() feeds it into swing splines and
the base-z reference.  Tests: map sampling, the reference feed, walking
≥1 m across the reference terrain scene, and walking UP an authored step.
"""
import dataclasses
import os

import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

MJCF_DIR = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/unitree_h1/h1_description/mjcf"
)
MJCF_TERRAIN = os.path.join(MJCF_DIR, "scene_terrain.xml")
pytestmark = pytest.mark.skipif(
    not os.path.exists(MJCF_TERRAIN), reason="H1 terrain scene unavailable"
)


def test_terrain_map_bilinear():
    from bipedal_nmpc.sim.terrain import TerrainMap

    z = np.zeros((3, 3))
    z[2, :] = 1.0  # ramp in x
    tm = TerrainMap(x0=0.0, y0=0.0, res=0.5, z=z)
    assert tm(0.0, 0.0) == 0.0
    assert abs(tm(0.75, 0.3) - 0.5) < 1e-9  # midway up the ramp
    assert abs(tm(1.0, 0.8) - 1.0) < 1e-3
    assert tm(-5.0, -5.0) == 0.0  # clamped outside the grid


def test_terrain_from_mujoco_raycast(tmp_path):
    """Raycast height sampling on an authored plane+box world: the box top
    reads 0.12, the plane 0, edges interpolate; the robot body (a free
    sphere) is teleported out and never shadows the rays."""
    mujoco = pytest.importorskip("mujoco")
    from bipedal_nmpc.sim.terrain import terrain_from_mujoco

    xml = """<mujoco>
      <worldbody>
        <geom type="plane" size="5 5 0.1"/>
        <geom type="box" pos="1.0 0 0.06" size="0.3 0.5 0.06"/>
        <body pos="0 0 1"><freejoint/><geom type="sphere" size="0.3"/></body>
      </worldbody>
    </mujoco>"""
    m = mujoco.MjModel.from_xml_string(xml)
    tm = terrain_from_mujoco(m, x_range=(-1, 2), y_range=(-1, 1), resolution=0.05)
    assert abs(tm(0.0, 0.0)) < 1e-6
    assert abs(tm(1.0, 0.0) - 0.12) < 1e-6
    assert abs(tm(-0.5, 0.5)) < 1e-6


def test_reference_manager_terrain_feed():
    """freeze() with a terrain_fn: stance swing splines sit AT terrain
    height, swing splines land at the touchdown foothold's height, and the
    target z is re-based to comHeight above local ground."""
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.reference.target import TargetTrajectories

    iface = make_interface_for("h1")
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.2)
    step_h, step_x = 0.1, 0.6
    rm.terrain_fn = lambda x, y: step_h if x > step_x else 0.0
    # target walks forward through the step over 2 s
    nx = iface.info.state_dim
    s0 = np.asarray(iface.initial_state).copy()
    s1 = s0.copy()
    s1[6] += 1.2  # 1.2 m ahead: past the step for every foothold
    rm.set_target(
        TargetTrajectories(
            times=np.array([0.0, 2.0]),
            states=np.stack([s0, s1]),
            inputs=np.zeros((2, iface.info.input_dim)),
        )
    )
    frozen = rm.freeze(0.0)

    # target z: first waypoint on flat ground (unchanged), later sample
    # past the step raised by step_h
    zs = np.asarray(frozen.target.states[:, 8])
    assert abs(zs[0] - s0[8]) < 1e-9
    assert abs(zs[1] - (s0[8] + step_h)) < 1e-9

    # swing table: before the gait starts everything is stance at height 0;
    # late in the horizon (past the step for the predicted footholds) the
    # stance splines sit at step_h
    z_early = float(frozen.swing.z_position(0, 0, 0.05))
    assert abs(z_early) < 1e-9
    # find a late phase where left toe is in stance and the foot is past
    # the step: query the spline near the end of the frozen window
    ev = np.asarray(frozen.gait.event_times)
    t_late = float(ev[np.isfinite(ev)][-1]) - 1e-3
    p_late = int(np.searchsorted(ev, t_late, side="right"))
    z_late = float(frozen.swing.z_position(0, p_late, t_late))
    assert abs(z_late - step_h) < 1e-3, (z_late, step_h)


def _walk(iface, sim, cmd_vx, duration, rm=None):
    from bipedal_nmpc.reference.target import CmdVelFollower
    from bipedal_nmpc.runtime.controller import BipedalController

    ctrl = BipedalController(iface, reference_manager=rm)
    ctrl.starting(sim.time, sim.rbd_state())
    ctrl.set_gait(iface.task.gait_library["trot"], start_time=sim.time + 0.4)
    control_dt = 1.0 / 500.0
    substeps = max(1, int(round(control_dt / sim.timestep)))
    follower = CmdVelFollower(
        np.array([cmd_vx, 0.0, 0.0, 0.0]), iface.command_config,
        iface.info.input_dim, ki=1.2, k_yaw=1.0, yaw_hold_delay_s=2.0,
    )
    walk_from = sim.time + 0.8
    for _ in range(int(duration / control_dt)):
        rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
        if sim.time >= walk_from:
            traj = follower.update(*ctrl.last_observation)
            if traj is not None:
                ctrl.set_target(traj)
        cmd = ctrl.update(sim.time, rbd)
        sim.apply_command(cmd)
        sim.step(substeps)
        if not ctrl.safe:
            break
    return ctrl, sim.ground_truth()[0]


def test_h1_walks_terrain_scene():
    """H1 walks >= 1 m across the reference's scene_terrain.xml with the
    terrain feed ACTIVE (height map raycast from the real scene; the
    walked corridor x in [-1.6, -0.2] at y=0 is the scene's flat patch —
    the 0.2 m box platform starts at x=+1.0)."""
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig
    from bipedal_nmpc.sim.terrain import terrain_from_mujoco

    iface = make_interface_for("h1")
    sim = MujocoSimBackend(
        MJCF_TERRAIN, list(iface.task.joint_names), MujocoSimConfig()
    )
    x0 = np.asarray(iface.initial_state).copy()
    spawn = np.array([-1.6, 0.0, 0.0])
    upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + spawn + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    tm = terrain_from_mujoco(sim.model, x_range=(-2.5, 1.0), y_range=(-1.5, 1.5))
    rm = iface.make_reference_manager()
    rm.terrain_fn = tm
    x_start = sim.ground_truth()[0][0]
    ctrl, pos = _walk(iface, sim, cmd_vx=0.35, duration=5.0, rm=rm)
    assert ctrl.safe, f"safety stop at t={sim.time:.2f}, base at {pos}"
    assert pos[0] - x_start >= 1.0, (pos[0], x_start)
    assert pos[2] > 0.9, pos


def test_h1_walks_up_step(tmp_path):
    """H1 walks UP an authored 4 cm step with terrain-fed swing heights and
    a terrain-rebased base-z reference — the z-reference machinery doing
    real work (nonzero heights), not just running against a flat patch.
    Measured 2026-08-22: climbs and continues to x=1.29 at z=1.026 (base
    rode the +0.04 terrain), upright throughout.  A 6 cm step FAILS with
    the current stack: the stride that straddles the edge lands a PARTIAL
    foothold (heel off the riser; foot xy is the MPC's emergent decision —
    there is no foothold-xy snapping away from edges), pitching the robot
    over at the edge.  Edge-aware foothold placement is the documented
    future lever, not swing-apex height (already over the max surface
    here — SwingConfig.apex_over_max_height)."""
    pytest.importorskip("mujoco")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig
    from bipedal_nmpc.sim.terrain import terrain_from_mujoco

    step_h = 0.04
    scene = tmp_path / "h1_step_scene.xml"
    scene.write_text(f"""<mujoco model="H1 step">
  <include file="{MJCF_DIR}/h1.xml" />
  <compiler meshdir="{MJCF_DIR}/assets" />
  <worldbody>
    <light pos="0 0 1.5" dir="0 0 -1" directional="true" />
    <geom name="floor" size="0 0 0.05" type="plane" />
    <geom name="step" type="box" pos="1.3 0 {step_h - 0.05}" size="0.8 1.5 0.05" />
  </worldbody>
</mujoco>""")
    iface = make_interface_for("h1")
    sim = MujocoSimBackend(str(scene), list(iface.task.joint_names), MujocoSimConfig())
    x0 = np.asarray(iface.initial_state).copy()
    upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    sim.reset(
        base_pos=x0[6:9] + np.array([0.0, 0.0, 0.017]),
        base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:],
        upper_joint_targets=upper,
    )
    tm = terrain_from_mujoco(sim.model, x_range=(-1.0, 2.5), y_range=(-1.0, 1.0))
    assert abs(tm(1.3, 0.0) - step_h) < 1e-6  # sampled the step
    rm = iface.make_reference_manager()
    rm.terrain_fn = tm
    # swing apex over the HIGHER surface: with the reference's min() formula
    # the toe clears the riser by only swingHeight - step_h and strikes the
    # edge on any foothold-prediction error (SwingConfig docstring)
    rm.swing_config = dataclasses.replace(rm.swing_config, apex_over_max_height=True)
    ctrl, pos = _walk(iface, sim, cmd_vx=0.3, duration=5.5, rm=rm)
    assert ctrl.safe, f"safety stop at t={sim.time:.2f}, base at {pos}"
    # climbed: both past the step edge (x=0.5) and standing ON it
    assert pos[0] > 0.8, pos
    assert pos[2] > 0.9 + step_h - 0.03, pos  # base height rode the terrain


def test_swing_apex_over_max_height():
    """SwingConfig.apex_over_max_height: stepping UP a riser, the apex sits
    swingHeight above the HIGHER surface (the reference's min() formula —
    faithful on flat ground where it was only ever run — leaves only
    swingHeight - dh of clearance and the toe strikes the riser edge)."""
    from bipedal_nmpc.gait.mode_schedule import ModeSchedule
    from bipedal_nmpc.gait.swing import SwingConfig, plan_swing_table

    sched = ModeSchedule([0.3, 0.65], [3, 2, 3])  # left swings in RF
    lift = np.zeros((4, 3))
    touch = np.zeros((4, 3))
    touch[0, :] = 0.06  # left toe lands on a 6 cm step
    mk = lambda **kw: plan_swing_table(
        SwingConfig(swing_height=0.08, swing_time_scale=0.15, **kw),
        sched, 8, lift_off_heights=lift, touch_down_heights=touch,
    )
    t_mid = 0.475  # swing midpoint (apex)
    z_min = float(mk().z_position(0, 1, t_mid))
    z_max = float(mk(apex_over_max_height=True).z_position(0, 1, t_mid))
    assert abs(z_min - (0.0 + 0.08)) < 1e-9  # reference formula: min + h
    assert abs(z_max - (0.06 + 0.08)) < 1e-9  # terrain mode: max + h
