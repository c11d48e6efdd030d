"""backend.select_backends: the one place that decides the solve path."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from bipedal_nmpc.backend import KERNEL_RICCATI, XLA_RICCATI, select_backends
from bipedal_nmpc.ocp.problem import OcpSettings

CPU = SimpleNamespace(platform="cpu")
GPU = SimpleNamespace(platform="gpu")


@pytest.mark.parametrize("device, expected", [(CPU, "sequential"), (GPU, "triton")])
def test_auto_resolves_per_device(device, expected):
    assert OcpSettings().riccati == "auto"
    assert select_backends(OcpSettings(), device).riccati == expected


@pytest.mark.parametrize("backend", XLA_RICCATI)
def test_xla_backends_run_everywhere(backend):
    for device in (CPU, GPU):
        s = select_backends(OcpSettings(riccati=backend), device)
        assert s.riccati == backend


@pytest.mark.parametrize("backend", sorted(KERNEL_RICCATI))
def test_kernel_on_wrong_device_raises(backend):
    """A kernel the device cannot compile raises: no interpreter, no
    fallback to the XLA scan."""
    with pytest.raises(ValueError, match="cannot be compiled"):
        select_backends(OcpSettings(riccati=backend), CPU)
    assert select_backends(OcpSettings(riccati=backend), GPU).riccati == backend


@pytest.mark.parametrize("backend", ["pallas", "lanes", ""])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unknown riccati backend"):
        select_backends(OcpSettings(riccati=backend), GPU)


def test_default_device_is_first_jax_device():
    assert jax.devices()[0].platform == "cpu"
    assert select_backends(OcpSettings()).riccati == "sequential"


def test_sqp_solve_refuses_kernel_on_cpu(tiny_problem):
    """sqp_solve routes through select_backends, so asking for the GPU
    kernel on this CPU raises while tracing."""
    from bipedal_nmpc.solver import sqp_solve

    model, info, settings, Q, R, refs, t_nodes, x0, xs, us = tiny_problem
    st = dataclasses.replace(settings, riccati="triton")
    with pytest.raises(ValueError, match="cannot be compiled"):
        jax.jit(lambda: sqp_solve(model, info, st, Q, R, refs, t_nodes, x0, xs, us))()


def test_sqp_solve_auto_runs_on_cpu(tiny_problem):
    """The default settings solve on this CPU through the XLA scan."""
    from bipedal_nmpc.solver import sqp_solve

    model, info, settings, Q, R, refs, t_nodes, x0, xs, us = tiny_problem
    sol = jax.jit(lambda: sqp_solve(model, info, settings, Q, R, refs, t_nodes, x0, xs, us))()
    ref = jax.jit(
        lambda: sqp_solve(
            model, info, dataclasses.replace(settings, riccati="sequential"),
            Q, R, refs, t_nodes, x0, xs, us,
        )
    )()
    assert bool(jnp.all(jnp.isfinite(sol.u_traj)))
    assert float(jnp.max(jnp.abs(sol.u_traj - ref.u_traj))) == 0.0


@pytest.fixture(scope="module")
def tiny_problem():
    """A 3-node stance problem on the tiny synthetic biped of conftest."""
    import numpy as np

    from bipedal_nmpc.ocp.problem import NodeRefs
    from bipedal_nmpc.solver import initial_trajectory
    from conftest import tiny_biped

    model, info = tiny_biped()
    N = 3
    settings = OcpSettings(dt=0.02, horizon=0.06, sqp_iterations=1)
    nx, nu = info.state_dim, info.input_dim
    x0 = np.zeros(nx)
    x0[8] = 0.6
    refs = NodeRefs(
        t=jnp.arange(N) * 0.02,
        dt=jnp.full(N, 0.02),
        contact_flags=jnp.ones((N, 4)),
        swing_vref=jnp.zeros((N, 4)),
        swing_pref=jnp.zeros((N, 4)),
        x_nom=jnp.tile(jnp.asarray(x0), (N, 1)),
        u_nom=jnp.zeros((N, nu)),
    )
    x0 = jnp.asarray(x0)
    xs, us = initial_trajectory(info, refs, x0, N + 1)
    Q, R = jnp.eye(nx), 1e-3 * jnp.eye(nu)
    return model, info, settings, Q, R, refs, jnp.arange(N + 1) * 0.02, x0, xs, us
