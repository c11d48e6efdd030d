"""Kinematics golden tests: closed-form chains, finite differences, MuJoCo oracle."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.model import (
    build_reduced_model,
    com_position,
    forward_kinematics,
    frame_jacobian,
    frame_jacobian_dot,
    frame_position,
    frame_transform,
    frame_velocity,
    from_description,
)
from bipedal_nmpc.utils.rotations import (
    euler_rate_map_zyx,
    rotmat_from_zyx,
    zyx_from_rotmat,
)

from conftest import H1_LEG_JOINTS, H1_URDF, _require_h1

PENDULUM_URDF = """
<robot name="pend2">
  <link name="base">
    <inertial><origin xyz="0 0 0"/><mass value="3.0"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial>
  </link>
  <link name="l1">
    <inertial><origin xyz="0 0 -0.5"/><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.02" izz="0.03"/></inertial>
  </link>
  <link name="l2">
    <inertial><origin xyz="0 0 -0.25"/><mass value="2.0"/>
      <inertia ixx="0.04" iyy="0.05" izz="0.06"/></inertial>
  </link>
  <link name="tip"/>
  <joint name="j1" type="revolute">
    <origin xyz="0.1 0 0" rpy="0 0 0"/><parent link="base"/><child link="l1"/>
    <axis xyz="0 1 0"/><limit lower="-3" upper="3" effort="10" velocity="5"/>
  </joint>
  <joint name="j2" type="revolute">
    <origin xyz="0 0 -1.0" rpy="0 0 0"/><parent link="l1"/><child link="l2"/>
    <axis xyz="0 1 0"/><limit lower="-3" upper="3" effort="10" velocity="5"/>
  </joint>
  <joint name="jt" type="fixed">
    <origin xyz="0 0 -0.5"/><parent link="l2"/><child link="tip"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module")
def pend():
    desc = build_reduced_model(PENDULUM_URDF, ["j1", "j2"])
    return from_description(desc)


def test_pendulum_fk_closed_form(pend):
    # base at origin, identity orientation
    q = jnp.array([0.0, 0, 0, 0, 0, 0, 0.3, -0.7])
    kin = forward_kinematics(pend, q)
    tip = frame_position(pend, kin, pend.frame_index("tip"))
    # planar chain in xz: revolute about +y, link lengths 1.0 then 0.5;
    # Rot_y(a) maps (0,0,-1) to (-sin a, 0, -cos a)
    a, b = 0.3, 0.3 - 0.7
    expected = np.array(
        [0.1 - np.sin(a) * 1.0 - np.sin(b) * 0.5, 0.0, -np.cos(a) * 1.0 - np.cos(b) * 0.5]
    )
    np.testing.assert_allclose(np.asarray(tip), expected, atol=1e-12)


def test_pendulum_fk_base_transform(pend):
    theta = jnp.array([0.4, -0.2, 0.9])
    p0 = jnp.array([1.0, -2.0, 3.0])
    q = jnp.concatenate([p0, theta, jnp.array([0.3, -0.7])])
    q_home = jnp.concatenate([jnp.zeros(6), jnp.array([0.3, -0.7])])
    kin = forward_kinematics(pend, q)
    kin0 = forward_kinematics(pend, q_home)
    R = rotmat_from_zyx(theta)
    fid = pend.frame_index("tip")
    np.testing.assert_allclose(
        np.asarray(frame_position(pend, kin, fid)),
        np.asarray(p0 + R @ frame_position(pend, kin0, fid)),
        atol=1e-12,
    )


def _random_qv(nj, rng, n=1):
    qs = np.concatenate(
        [
            rng.uniform(-1, 1, (n, 3)),
            rng.uniform(-0.9, 0.9, (n, 3)),
            rng.uniform(-1.2, 1.2, (n, nj)),
        ],
        axis=1,
    )
    vs = rng.uniform(-1, 1, (n, 6 + nj))
    return qs, vs


def test_jacobian_matches_finite_difference(h1_model, rng):
    model = h1_model
    qs, vs = _random_qv(model.nj, rng, 3)
    for q, v in zip(qs, vs):
        q, v = jnp.asarray(q), jnp.asarray(v)
        for name in ["left_sole_1_link", "right_sole_2_link", "pelvis"]:
            fid = model.frame_index(name)
            J = frame_jacobian(model, q, fid)
            # linear rows: J_v @ v == d/dt p(q + t v)
            pdot = jax.jvp(
                lambda qq: frame_position(model, forward_kinematics(model, qq), fid), (q,), (v,)
            )[1]
            np.testing.assert_allclose(np.asarray(J[:3] @ v), np.asarray(pdot), atol=1e-10)
            # angular rows: skew(omega) == Rdot R^T
            Rdot = jax.jvp(
                lambda qq: frame_transform(model, forward_kinematics(model, qq), fid)[0], (q,), (v,)
            )[1]
            R, _ = frame_transform(model, forward_kinematics(model, q), fid)
            W = Rdot @ R.T
            omega = jnp.stack([W[2, 1], W[0, 2], W[1, 0]])
            np.testing.assert_allclose(np.asarray(J[3:] @ v), np.asarray(omega), atol=1e-10)


def test_jacobian_dot_consistency(h1_model, rng):
    """Jdot from jvp equals finite-difference of J along the flow."""
    model = h1_model
    qs, vs = _random_qv(model.nj, rng, 2)
    fid = model.frame_index("left_sole_2_link")
    eps = 1e-6
    for q, v in zip(qs, vs):
        q, v = jnp.asarray(q), jnp.asarray(v)
        Jd = frame_jacobian_dot(model, q, v, fid)
        J1 = frame_jacobian(model, q + eps * v, fid)
        J0 = frame_jacobian(model, q - eps * v, fid)
        np.testing.assert_allclose(np.asarray(Jd), np.asarray((J1 - J0) / (2 * eps)), atol=1e-6)


# ---------------------------------------------------------------- MuJoCo oracle
def _h1_mujoco_full():
    mujoco = pytest.importorskip("mujoco")
    _require_h1()
    urdf = open(H1_URDF).read()
    urdf = re.sub(r"<visual>.*?</visual>", "", urdf, flags=re.S)
    urdf = re.sub(r"<collision>.*?</collision>", "", urdf, flags=re.S)
    urdf = urdf.replace("<mujoco>", "<mujoco_off>").replace("</mujoco>", "</mujoco_off>")
    spec = mujoco.MjSpec.from_string(urdf)
    pelvis = [b for b in spec.bodies if b.name == "pelvis"][0]
    pelvis.add_freejoint()
    m = spec.compile()
    d = mujoco.MjData(m)
    joint_names = [
        mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j) for j in range(1, m.njnt)
    ]  # skip the free joint
    return mujoco, m, d, joint_names


def _set_mj_state(mujoco, m, d, model, q, v):
    """Map our (q, v) into MuJoCo qpos/qvel (free joint: quat wxyz; qvel
    angular is body-local, linear is world)."""
    from scipy.spatial.transform import Rotation

    theta = np.asarray(q[3:6])
    R = Rotation.from_euler("ZYX", theta).as_matrix()
    quat_xyzw = Rotation.from_matrix(R).as_quat()
    d.qpos[:3] = np.asarray(q[:3])
    d.qpos[3:7] = [quat_xyzw[3], *quat_xyzw[:3]]
    E = np.asarray(euler_rate_map_zyx(jnp.asarray(theta)))
    omega_world = E @ np.asarray(v[3:6])
    d.qvel[:3] = np.asarray(v[:3])
    d.qvel[3:6] = R.T @ omega_world
    # joints: our order must be mapped to mujoco's joint order
    for our_idx, name in enumerate(model.joint_names):
        adr = m.jnt_qposadr[mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, name)]
        dadr = m.jnt_dofadr[mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, name)]
        d.qpos[adr] = np.asarray(q[6 + our_idx])
        d.qvel[dadr] = np.asarray(v[6 + our_idx])
    mujoco.mj_forward(m, d)
    return R


@pytest.fixture(scope="module")
def h1_full_pair():
    """(our full 19-joint model, mujoco model) over the same URDF."""
    mujoco, m, d, mj_joints = _h1_mujoco_full()
    from bipedal_nmpc.model import load_urdf

    desc = load_urdf(H1_URDF, mj_joints)  # all joints actuated, mujoco order
    model = from_description(desc)
    return mujoco, m, d, model


def test_h1_fk_against_mujoco(h1_full_pair, rng):
    mujoco, m, d, model = h1_full_pair
    for _ in range(3):
        q = np.concatenate(
            [rng.uniform(-1, 1, 3), rng.uniform(-0.8, 0.8, 3), rng.uniform(-0.8, 0.8, model.nj)]
        )
        v = np.zeros(model.nv)
        _set_mj_state(mujoco, m, d, model, q, v)
        kin = forward_kinematics(model, jnp.asarray(q))
        for name in ["left_ankle_link", "right_knee_link", "left_elbow_link", "torso_link"]:
            fid = model.frame_index(name)
            p_ours = np.asarray(frame_position(model, kin, fid))
            bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, name)
            np.testing.assert_allclose(p_ours, d.xpos[bid], atol=1e-9)
        # whole-robot com
        com_ours = np.asarray(com_position(model, kin))
        mujoco.mj_forward(m, d)
        np.testing.assert_allclose(com_ours, d.subtree_com[1], atol=1e-9)


def test_h1_frame_velocity_against_mujoco(h1_full_pair, rng):
    mujoco, m, d, model = h1_full_pair
    q = np.concatenate([rng.uniform(-1, 1, 3), rng.uniform(-0.8, 0.8, 3), rng.uniform(-0.8, 0.8, model.nj)])
    v = rng.uniform(-1, 1, model.nv)
    _set_mj_state(mujoco, m, d, model, q, v)
    for name in ["left_ankle_link", "right_ankle_link"]:
        fid = model.frame_index(name)
        vel6 = np.asarray(frame_velocity(model, jnp.asarray(q), jnp.asarray(v), fid))
        bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, name)
        out = np.zeros(6)
        mujoco.mj_objectVelocity(m, d, mujoco.mjtObj.mjOBJ_XBODY, bid, out, 0)
        np.testing.assert_allclose(vel6[:3], out[3:], atol=1e-9)  # linear
        np.testing.assert_allclose(vel6[3:], out[:3], atol=1e-9)  # angular


def test_reduced_model_matches_full_locked(h1_full_pair, rng):
    """Welding the upper body at zero == full model with zero upper q."""
    _, _, _, full = h1_full_pair
    from bipedal_nmpc.model import load_urdf

    red = from_description(load_urdf(H1_URDF, H1_LEG_JOINTS))
    q_red = np.concatenate([rng.uniform(-1, 1, 6) * 0.5, rng.uniform(-0.8, 0.8, red.nj)])
    q_full = np.concatenate([q_red[:6], np.zeros(full.nj)])
    for our_idx, name in enumerate(red.joint_names):
        q_full[6 + full.joint_names.index(name)] = q_red[6 + our_idx]
    kin_r = forward_kinematics(red, jnp.asarray(q_red))
    kin_f = forward_kinematics(full, jnp.asarray(q_full))
    for name in ["left_sole_1_link", "right_sole_1_link"]:
        np.testing.assert_allclose(
            np.asarray(frame_position(red, kin_r, red.frame_index(name))),
            np.asarray(frame_position(full, kin_f, full.frame_index(name))),
            atol=1e-12,
        )
    np.testing.assert_allclose(
        np.asarray(com_position(red, kin_r)), np.asarray(com_position(full, kin_f)), atol=1e-12
    )


def test_euler_rate_map_roundtrip(rng):
    theta = jnp.asarray(rng.uniform(-1.2, 1.2, 3))
    R = rotmat_from_zyx(theta)
    np.testing.assert_allclose(np.asarray(zyx_from_rotmat(R)), np.asarray(theta), atol=1e-12)
    # E columns = world axes of euler rotations: check via Rdot R^T
    td = jnp.asarray(rng.uniform(-1, 1, 3))
    Rdot = jax.jvp(rotmat_from_zyx, (theta,), (td,))[1]
    W = Rdot @ R.T
    omega = np.array([W[2, 1], W[0, 2], W[1, 0]])
    np.testing.assert_allclose(np.asarray(euler_rate_map_zyx(theta) @ td), omega, atol=1e-12)
