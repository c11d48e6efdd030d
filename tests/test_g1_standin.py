"""The in-repo G1 stand-in description (configs/g1/g1_standin.urdf) meets
what its header promises: the task config's joints, contacts and effort
limits, a 35 kg robot, and soles on the ground under the CoM at the task's
initial state."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def g1():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("g1")


def test_joint_and_contact_counts(g1):
    from bipedal_nmpc.ocp.problem import NUM_EQ

    info, task = g1.info, g1.task
    assert g1.model.joint_names == tuple(task.joint_names)
    assert len(task.joint_names) == 12 and len(task.upper_joint_names) == 11
    assert len(info.contact_frame_ids) == 4
    assert (info.state_dim, info.input_dim, NUM_EQ) == (24, 24, 16)
    assert g1.settings.num_intervals == 67


def test_mass_and_limits(g1):
    from bipedal_nmpc.model.urdf import load_urdf
    from bipedal_nmpc.robots import get_assets

    assert abs(float(g1.info.robot_mass) - 35.0) < 0.5
    # every link's mass is kept: the upper body is welded, not dropped
    desc = load_urdf(get_assets("g1").urdf, g1.task.joint_names)
    assert abs(desc.total_mass - float(g1.info.robot_mass)) < 1e-9
    # leg effort limits == the task file's torqueLimitsTask (hip, knee, ankle)
    np.testing.assert_allclose(
        desc.joint_limit_effort[:6], [88, 88, 88, 139, 50, 50]
    )
    np.testing.assert_allclose(desc.joint_limit_effort[6:], desc.joint_limit_effort[:6])


def test_soles_on_ground_under_com(g1):
    import jax.numpy as jnp

    from bipedal_nmpc.model.kinematics import com_position, forward_kinematics, frame_position

    x0 = np.asarray(g1.initial_state)
    kin = forward_kinematics(g1.model, jnp.asarray(x0[6:]))
    soles = np.stack(
        [np.asarray(frame_position(g1.model, kin, f)) for f in g1.info.contact_frame_ids]
    )
    assert np.all(np.abs(soles[:, 2]) < 0.01), soles[:, 2]
    # whole-body CoM inside the support rectangle of the four soles
    com = np.asarray(com_position(g1.model, kin))
    lo, hi = soles[:, :2].min(axis=0), soles[:, :2].max(axis=0)
    assert np.all(com[:2] > lo) and np.all(com[:2] < hi), (com, lo, hi)


def test_missing_assets_name_the_variable(monkeypatch):
    """Robots whose files are not in the repository raise, naming
    $BIPEDAL_ASSETS; nothing falls back to a default path."""
    from bipedal_nmpc.interface import make_interface_for

    monkeypatch.delenv("BIPEDAL_ASSETS", raising=False)
    for robot in ("h1", "hunter", "openloong"):
        with pytest.raises(FileNotFoundError, match=r"\$BIPEDAL_ASSETS"):
            make_interface_for(robot)
