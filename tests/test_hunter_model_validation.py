"""Hunter model validation vs MuJoCo at random configurations.

Hunter is the only robot with mixed-sign joint axes (left-leg pitch joints
are -y, right-leg +y, plus an x hip roll and z hip yaw), and until round 4
it appeared in no model-validation test — the round-4 closed-loop debugging
ran this comparison ad hoc and it is now pinned: FK body positions, total
CoM, and CMM linear momentum against MuJoCo on the generated scene at
random base poses / joint angles / joint velocities."""
import os

import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

URDF = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/hunter/legged_hunter_description/urdf/hunter.urdf"
)
pytestmark = pytest.mark.skipif(not os.path.exists(URDF), reason="hunter URDF unavailable")


def test_hunter_fk_com_momentum_vs_mujoco(tmp_path):
    mujoco = pytest.importorskip("mujoco")
    import jax.numpy as jnp

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.model.centroidal import centroidal_momentum_matrix
    from bipedal_nmpc.model.kinematics import forward_kinematics
    from bipedal_nmpc.sim.urdf_mjcf import build_mjcf_scene_from_urdf
    from bipedal_nmpc.utils.rotations import rotmat_from_zyx

    iface = make_interface_for("hunter")
    model = iface.model
    scene = build_mjcf_scene_from_urdf(
        URDF, list(iface.task.joint_names),
        armature=iface.task.sim_joint_armature, out_path=str(tmp_path / "scene.xml")
    )
    m = mujoco.MjModel.from_xml_path(scene)
    d = mujoco.MjData(m)
    rng = np.random.default_rng(0)

    for _ in range(3):
        q = np.zeros(16)
        q[2] = 0.8
        q[3:6] = rng.normal(scale=0.3, size=3)
        q[6:] = rng.normal(scale=0.5, size=10)
        v = np.zeros(16)
        v[6:] = rng.normal(scale=1.0, size=10)

        R = np.asarray(rotmat_from_zyx(jnp.asarray(q[3:6])))
        quat = np.zeros(4)
        mujoco.mju_mat2Quat(quat, R.flatten())
        d.qpos[:3] = q[:3]
        d.qpos[3:7] = quat
        for i, name in enumerate(iface.task.joint_names):
            j = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, name)
            d.qpos[m.jnt_qposadr[j]] = q[6 + i]
            d.qvel[m.jnt_dofadr[j]] = v[6 + i]
        d.qvel[:6] = 0
        mujoco.mj_forward(m, d)
        mujoco.mj_subtreeVel(m, d)  # populates subtree_linvel

        kin = forward_kinematics(model, jnp.asarray(q))
        p_b = np.asarray(kin.p)
        R_b = np.asarray(kin.R)
        for b in range(1, model.nb):
            name = iface.task.joint_names[b - 1].replace("_joint", "_link")
            bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, name)
            assert bid >= 0
            assert np.max(np.abs(p_b[b] - d.xpos[bid])) < 1e-10

        com = np.zeros(3)
        for b in range(model.nb):
            mb = float(model.body_mass[b])
            com += mb * (p_b[b] + R_b[b] @ np.asarray(model.body_com[b]))
        com /= float(model.total_mass)
        assert np.max(np.abs(com - d.subtree_com[1])) < 1e-6

        A = np.asarray(centroidal_momentum_matrix(model, jnp.asarray(q)))
        P_ours = (A @ v)[:3]
        P_mj = m.body_subtreemass[1] * d.subtree_linvel[1]
        assert np.max(np.abs(P_ours - P_mj)) < 1e-5, (P_ours, P_mj)
