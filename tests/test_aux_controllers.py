"""Initial/upper joint controllers and policy checkpointing."""
import numpy as np

from bipedal_nmpc.runtime.aux_controllers import (
    InitialJointPositionController,
    UpperJointController,
    load_policy,
    save_policy,
)


def test_initial_controller_ramp_and_clamp():
    ctrl = InitialJointPositionController(
        target=np.array([0.5, -2.0]),  # second exceeds the limit
        lower=np.array([-1.0, -1.0]),
        upper=np.array([1.0, 1.0]),
        duration=1.0,
    )
    q0 = np.array([0.0, 0.0])
    ctrl.starting(0.0, q0)
    half = ctrl.update(0.5, q0, np.zeros(2))
    np.testing.assert_allclose(half.pos_des, [0.25, -0.5])  # clamped target -1.0
    done = ctrl.update(2.0, q0, np.zeros(2))
    np.testing.assert_allclose(done.pos_des, [0.5, -1.0])
    assert np.all(done.kp == 100.0)


def test_upper_controller_holds():
    ctrl = UpperJointController(target=np.array([0.0, -1.2]))
    cmd = ctrl.update(0.0, np.zeros(2), np.zeros(2))
    np.testing.assert_allclose(cmd.pos_des, [0.0, -1.2])
    assert cmd.kp[0] == 100.0 and cmd.kd[0] == 3.0


def test_policy_save_load_roundtrip(tmp_path):
    import jax.numpy as jnp

    from bipedal_nmpc.solver.sqp import SqpSolution

    sol = SqpSolution(
        t_nodes=jnp.linspace(0, 1, 5),
        x_traj=jnp.ones((5, 3)),
        u_traj=jnp.ones((4, 2)) * 2,
        K=jnp.ones((4, 2, 3)) * 3,
        cost=jnp.asarray(1.5),
        defect_norm=jnp.asarray(0.1),
        eq_norm=jnp.asarray(0.2),
        step_size=jnp.asarray(1.0),
    )
    p = str(tmp_path / "policy.npz")
    save_policy(p, sol)
    back = load_policy(p)
    np.testing.assert_allclose(np.asarray(back.K), 3.0)
    np.testing.assert_allclose(np.asarray(back.t_nodes), np.asarray(sol.t_nodes))
